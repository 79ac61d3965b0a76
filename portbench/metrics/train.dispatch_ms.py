"""``train.dispatch_ms``: the mean DISPATCH lap of the training loop's
flight recorder (``steptrace.StepRecorder``) over the window's steps, in
ms: the host's time to launch one step's work."""


def read(run):
    laps = run.data.get("dispatch_s") or []
    return 1e3 * sum(laps) / len(laps) if laps else None
