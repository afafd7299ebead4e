"""The mamba layers' SSD scans in the traced stretch: the work a step of
them requires (the family's `ssd_ops` and `ssd_bytes` of one layer's scan,
forward plus a backward of twice that, every layer; remat's recompute not
counted), at the larger of its operations at the card's bf16 tensor peak
and its bytes at HBM bandwidth, over `ssd_ms.train`, in %. The bf16 peak
keeps the share of a scan run on the tensor cores at or under 100 %. None
for a family without a scan, or where the trace holds no `ssd` range."""
from pathlib import Path

from harness import spec

ROOT = Path(__file__).resolve().parents[2]


def read(run):
    if run.kind != "train" or "bf16_flops" not in run.peaks:
        return None
    fam = spec.family(run.cfg, ROOT)
    if not hasattr(fam, "ssd_ops"):
        return None
    ms = spec.reader(ROOT, "ssd_ms.train")(run)
    if not ms:
        return None
    cfg, B, S = run.cfg, run.mix["batch"], run.mix["seq"]
    layer_s = max(fam.ssd_ops(cfg, B, S) / run.peaks["bf16_flops"],
                  fam.ssd_bytes(cfg, B, S) / run.peaks["hbm_bytes_per_s"])
    return 100.0 * 3 * cfg["num_hidden_layers"] * layer_s / (ms / 1e3)
