"""``wgridder.transform.device_ms`` (ms): device time per call of every
kernel but the two w-stack spreading kernels (``tile_spread_kernel``,
``stack_gather_kernel``) in the traced sub-window: the FFTs, the crop and
pad, the phase screens and their products, the tapers, Stokes I and the
subtraction of the model. Nothing to read where neither spreading kernel
ran (no w-stack) or no kernel ran."""

SPREADING = ("tile_spread_kernel", "stack_gather_kernel")


def read(rec):
    if not rec.kernels or not rec.kernel_seconds(lambda n: n in SPREADING):
        return None
    return 1e3 * rec.kernel_seconds(lambda n: n not in SPREADING) / rec.calls
