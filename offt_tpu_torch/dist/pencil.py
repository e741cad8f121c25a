"""The local 1-D transform dispatch of the pencil dataflow.

Counterpart of ``offt_tpu/dist/pencil.py``. Only ``axis_fft`` is ported:
the single-device axis-by-axis route (``plan.api._local_fft3d``) runs one
per axis. The pencil engine itself (the two exchange phases, chunking,
the ring and gather variants) is ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

from ..kernels import fourstep
from ..kernels import fused_fft as ff


def axis_fft(xr, xi, axis: int, inverse: bool, radices, params,
             out_scale: float = 1.0, tables=None):
    """One planar 1-D c2c along ``axis`` (numpy fft/ifft semantics), with
    the reference's dispatch: the 2-stage kernels (``fft_1d_planar``)
    when the axis is expressible; the four-step route for the last axis
    with no radices; else NotImplementedError (the unfused Stockham /
    Bluestein engine is ROADMAP Queue 1 item 7). ``out_scale`` rides the
    kernels' tables."""
    axis = axis % xr.ndim
    n = xr.shape[axis]
    if ff.can_use_pallas(n, radices):
        return ff.fft_1d_planar(xr, xi, axis, inverse=inverse,
                                radices=radices, precision=params.precision,
                                block=params.block_batch,
                                out_scale=out_scale, x_tile=params.x_tile,
                                tables=tables)
    if (axis == xr.ndim - 1 and radices is None
            and fourstep.can_use_four_step(n, params.split_1d)):
        return fourstep.fft_four_step_planar(
            xr, xi, inverse=inverse, split=params.split_1d,
            precision=params.precision, out_scale=out_scale,
            block=params.block_batch, tables=tables)
    raise NotImplementedError(
        f"N={n} along axis {axis} (radices {radices}) needs the unfused "
        "Stockham/Bluestein engine, ROADMAP Queue 1 item 7")
