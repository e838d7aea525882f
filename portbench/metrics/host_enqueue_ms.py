"""``host_enqueue_ms.<family>``: the host's milliseconds a step inside the
program's ``conv:*`` spans (the conv passes' dispatch, lowering and
launches), the median over steps each started after a
``synchronize()``, so that no full launch queue holds a launch back."""

import statistics


def read(ctx):
    if not ctx.enqueue_ms:
        return None
    return statistics.median(ctx.enqueue_ms)
