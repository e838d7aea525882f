"""``device_idle.<family>``: the share (%) of the traced stretch in which
no kernel, copy or fill runs on the device (``lib/profile.py``: the union
of the device operations' intervals, against the stretch's length), in
the stretch traced on the device only, where the host runs as in the
window."""


def read(ctx):
    if ctx.stretch is None or ctx.stretch.window_s <= 0 \
            or not ctx.stretch.device_events:
        return None
    return 100.0 * ctx.stretch.idle_share
