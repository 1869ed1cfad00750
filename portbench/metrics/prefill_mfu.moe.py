"""prefill_mfu.moe: ``prefill_mfu``, read the same way, in a cell that
reports ``tpot_p90_ms`` and not ``ttft_p90_ms`` (see ``prefill_ms.moe``)."""
from portbench.metrics.prefill_mfu import read  # noqa: F401
