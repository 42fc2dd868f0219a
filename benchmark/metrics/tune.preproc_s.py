"""Host planning: the port's own ``preproc`` timer of the tune
(``CsxMatrix.timers``: partition, mining, encoding, plan and upload)."""


def read(run):
    return run.tune_preproc_s
