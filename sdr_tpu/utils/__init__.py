from sdr_tpu.utils.args import parse_size  # noqa: F401
from sdr_tpu.utils.cache import enable_compile_cache  # noqa: F401
from sdr_tpu.utils.device import (  # noqa: F401
    device_kind,
    device_family,
    best_method,
    feature_select,
)
from sdr_tpu.utils.profiling import trace, profile, timed  # noqa: F401
from sdr_tpu.utils.roofline import (  # noqa: F401
    chain_roofline,
    stage_costs,
    Ceilings,
    PEAKS,
    peaks_for,
)
