"""prefill_ms.moe: ``prefill_ms``, read the same way, in a cell that
reports ``tpot_p90_ms`` and not ``ttft_p90_ms``.  Each prefill holds up
every slot's decode for its length, so it moves ``tpot_p90_ms`` there."""
from portbench.metrics.prefill_ms import read  # noqa: F401
