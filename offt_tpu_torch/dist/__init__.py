"""Distribution. Only the single-device axis dispatch (``pencil.axis_fft``)
is ported so far; the pencil engine is ROADMAP Queue 1 item 14."""
