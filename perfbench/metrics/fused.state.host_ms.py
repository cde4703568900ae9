"""``fused.state.host_ms`` (ms): the host time of the fused RIME's state
build (``np.unique`` of the time and antenna columns, their lookups, the
arguments put on the device, transformers) per evaluation in the traced
sub-window: the program's ``RimeFactory.state_seconds`` over
``RimeFactory.calls``, counted only while a profiler records. Nothing to
read where the program keeps no such count or the fused RIME did not
run."""


def read(rec):
    from africanus_tpu_torch.rime.fused.core import RimeFactory

    seconds = getattr(RimeFactory, "state_seconds", None)
    calls = getattr(RimeFactory, "calls", None)
    if seconds is None or calls is None or not calls.value:
        return None
    return 1e3 * seconds.value / calls.value
