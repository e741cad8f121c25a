"""Observability: the JSONL event log (``log``), its viewer (``view``),
device timing and per-stage breakdowns (``profile``)."""

from .log import EventLog, read_events

__all__ = ["EventLog", "read_events"]
