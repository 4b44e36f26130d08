"""train_step_ms_p90.dp4 (ms): the 90th percentile of every step of the
traced run's window, as the end-to-end ``train_step_ms_p90`` takes it
(``stats.percentile``): each step's time between the CUDA events at
consecutive step ends on the compute stream, the slowest rank's."""

from perfbench import stats


def read(run):
    if not run.step_ms:
        return None
    return stats.percentile(run.step_ms, 90)
