"""K3 (paged attention) in the traced stretch: its byte bound per launch
from the kv lengths of every slot in the round (harness/flops.py
`paged_attention_bound`, a launch a layer a round) over its kernels'
device time by name, in %."""
from harness import flops

KERNELS = ("paged_attn_bf16", "paged_attn_f32", "combine_splits")


def read(run):
    if run.kind != "serve" or run.trace is None or not run.k3_rounds:
        return None
    device_s, _ = run.trace.kernel_s(KERNELS)
    if device_s <= 0 or "hbm_bytes_per_s" not in run.peaks:
        return None
    cfg = run.cfg
    H = cfg["num_attention_heads"]
    K = cfg.get("num_key_value_heads", H)
    hd = cfg.get("model", {}).get("head_dim", cfg["hidden_size"] // H)
    elem = 2 if cfg.get("torch_dtype") == "bfloat16" else 4
    bound = sum(flops.paged_attention_bound(kv, H, K, hd, elem, run.peaks)
                for kv in run.k3_rounds) * cfg["num_hidden_layers"]
    return 100.0 * bound / device_s
