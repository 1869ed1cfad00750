"""flash_roofline: the flash-attention launches of the profiled
sub-window, the least time the card could take for each (the frozen
bound of ``counters.flash_bound_s`` from its prompt's length) summed,
over their summed device time.  Nothing where the trace holds another
number of flash kernels than the program counted launches, or than the
traced prefills account for: a share of a partial sum would mislead."""
from portbench import counters

KERNEL = "flash_attention"


def read(run):
    trace = run["trace"]
    if trace is None or not trace["flash_launches"]:
        return None
    kernels = [e for e in trace["device"] if KERNEL in e[0]]
    cfg = run["config"]
    prompts = [s["info"]["tokens"] for s in run["spans"]
               if s["kind"] == "prefill" and s["traced"]]
    layers = cfg["num_layers"]
    if len(kernels) != trace["flash_launches"] or \
            len(kernels) != layers * len(prompts):
        return None
    hd = cfg["d_model"] // cfg["num_heads"]
    bound = sum(layers * counters.flash_bound_s(T, cfg["num_heads"],
                                                 cfg["num_kv_heads"], hd,
                                                 run["peaks"])
                for T in prompts)
    device_s = sum(end - start for _, start, end, _ in kernels) * 1e-9
    return bound / device_s * 100
