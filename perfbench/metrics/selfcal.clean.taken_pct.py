"""``selfcal.clean.taken_pct`` (%): of CLEAN's iterations in the traced
sub-window, the share that took a component: the program's
``hogbom_clean.taken``, whose flags are kept only while a profiler
records and summed here, once the window has closed. Nothing to read
where the program keeps no such count or CLEAN did not run."""


def read(rec):
    from africanus_tpu_torch.deconv.hogbom import hogbom_clean

    count = getattr(hogbom_clean, "taken", None)
    if count is None:
        return None
    taken, iterations = count.read()
    return 100.0 * taken / iterations if iterations else None
