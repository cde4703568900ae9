"""Time/channel and baseline-dependent averaging (port of
``africanus_tpu/averaging``): host mappers, device segmented sums."""

from africanus_tpu_torch.averaging.support import unique_time, unique_baselines
from africanus_tpu_torch.averaging.time_and_channel_mapping import (
    row_mapper,
    channel_mapper,
    RowMapOutput,
)
from africanus_tpu_torch.averaging.time_and_channel_avg import (
    row_average,
    row_chan_average,
    chan_average,
    time_and_channel,
    AverageOutput,
)

__all__ = [
    "unique_time",
    "unique_baselines",
    "row_mapper",
    "channel_mapper",
    "RowMapOutput",
    "row_average",
    "row_chan_average",
    "chan_average",
    "time_and_channel",
    "AverageOutput",
]
from africanus_tpu_torch.averaging.bda_mapping import bda_mapper
from africanus_tpu_torch.averaging.bda_avg import bda
__all__ += ["bda_mapper", "bda"]
from africanus_tpu_torch.averaging.shared import merge_flags
__all__ += ["merge_flags"]
from africanus_tpu_torch.averaging.splines import (
    Spline,
    fit_cubic_spline,
    evaluate_spline,
)
__all__ += ["Spline", "fit_cubic_spline", "evaluate_spline"]
