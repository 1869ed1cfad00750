"""flash_roofline.moe: ``flash_roofline``, read the same way, in a cell
that reports ``tpot_p90_ms`` and not ``ttft_p90_ms`` (see
``prefill_ms.moe``)."""
from portbench.metrics.flash_roofline import read  # noqa: F401
