"""The file latency's tail in the traced share of the window: the 95th
percentile (nearest rank) of the walls of the files completed there, each
from its submission to its result, in seconds.  It is ``file_p95_s`` read
beside the per-layer metrics, for a cell whose end-to-end tail swings with
the host more than a bound can hold; the profiler is on while these files
run, so it reads somewhat above the untraced tail."""
from perfbench.harness import stats


def read(ctx):
    walls = [f.t_done - f.t_submit for f in ctx.files]
    if not walls:
        return None
    return stats.p95(walls)
