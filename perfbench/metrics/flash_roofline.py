"""The least time of the attention work that the profiled slice's batches
need past ``attn_chunk`` tokens (the larger of its operations at the
bf16 peak and its bytes at the HBM peak, per layer and batch) over the
device time of the ``flash_attention`` kernels in the slice, in percent.
Nothing to read where no such kernel ran."""
from perfbench import counts


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    flash_s = sum(s for name, s in tr["device_s"].items()
                  if "flash_attention" in name)
    m = rec["model"]
    H = m["n_heads"]
    D = m["d_model"] // H
    need = 0.0
    for b, res in tr["calls"]:
        S = counts.vit_tokens(m, res)
        if S > rec["attn_chunk"]:
            need += m["n_layers"] * counts.attention_min_s(
                b, S, H, D, rec["elem_bytes"])
    if flash_s <= 0 or need <= 0:
        return None
    return 100.0 * need / flash_s
