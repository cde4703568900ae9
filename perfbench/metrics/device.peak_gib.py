"""``device.peak_gib`` (GiB): ``torch.cuda.max_memory_allocated`` over
the run's set-up and measured window."""


def read(rec):
    if not rec.peak_bytes:
        return None
    return rec.peak_bytes / 2.0 ** 30
