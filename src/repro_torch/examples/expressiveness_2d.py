"""Paper Appendix C.2 (Figure 7), reproduced end-to-end: 8-class 2-D
Gaussian-blob classification through a single 64x64 hidden layer, adapting
it with LoRA r=1 vs FourierFT n=128 — EQUAL trainable parameter count (128)
(the JAX package's `examples/expressiveness_2d.py` on the port).

The paper's claim: LoRA r=1 hits an expressiveness bottleneck (never reaches
100% within 2000 epochs) while FourierFT reaches 100% quickly.

    PYTHONPATH=src python -m repro_torch.examples.expressiveness_2d
    PYTHONPATH=src python -m repro_torch.examples.expressiveness_2d --device cpu

The base weights and LoRA's A come from `core/prng.py`'s threefry stream,
the draws `jax.random.normal` makes from the same keys (normals within a
few float32 ulps), so the run follows the JAX script's trajectory.
`--steps` cuts the 2000 epochs.
"""
import argparse

import torch

from repro_torch.core import fourierft, lora, prng
from repro_torch.data import SyntheticClassification
from repro_torch.devices import resolve_device

D = 64


def _normal(key, shape, device):
    return torch.from_numpy(prng.normal(key, shape)).to(device)


def make_base(key, device):
    ks = prng.split(key, 4)
    return {
        "w_in": _normal(ks[0], (2, D), device) * 0.5,
        "b_in": torch.zeros(D, device=device),
        "w_hid": _normal(ks[1], (D, D), device) * 0.2,   # the adapted layer
        "b_hid": torch.zeros(D, device=device),
        "w_out": _normal(ks[2], (D, 8), device) * 0.3,
        "b_out": torch.zeros(8, device=device),
    }


def forward(base, delta_fn, x):
    h = torch.relu(x @ base["w_in"] + base["b_in"])
    h = torch.relu(h @ (base["w_hid"] + delta_fn()) + base["b_hid"])
    return h @ base["w_out"] + base["b_out"]


def train(method: str, device, epochs: int = 2000, lr: float = 0.1,
          seed: int = 0):
    x, y = SyntheticClassification(num_classes=8, dim=2, noise=0.22,
                                   seed=3).dataset(64, device=device)
    base = make_base(prng.prng_key(seed), device)
    if method == "fourierft":
        entries = fourierft.sample_entries(D, D, 128, seed=2024).to(device)
        train_p = {"c": torch.zeros(128, device=device)}
        delta = lambda p: fourierft.materialize_delta(
            p["c"], entries, D, D, alpha=float(D * D))
    else:  # lora r=1 -> 2*64 = 128 params, equal budget
        # A ~ N(0, 1/r) from the key JAX's init_lora takes, B = 0
        train_p = {"lora_a": _normal(prng.prng_key(seed + 1), (D, 1),
                                     device),
                   "lora_b": torch.zeros((1, D), device=device)}
        delta = lambda p: lora.lora_delta(p["lora_a"], p["lora_b"], 2.0, 1)
    onehot = torch.nn.functional.one_hot(y.long(), 8).to(torch.float32)

    def loss_fn(p):
        logits = forward(base, lambda: delta(p), x)
        return -torch.mean(torch.sum(torch.log_softmax(logits, -1) * onehot,
                                     -1))

    def step(p):
        live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = loss_fn(live)
        grads = torch.autograd.grad(loss, list(live.values()))
        return {k: v.detach() - lr * g for (k, v), g in zip(live.items(),
                                                            grads)}, \
            loss.detach()

    def acc_fn(p):
        with torch.no_grad():
            return (torch.argmax(forward(base, lambda: delta(p), x), -1)
                    == y).to(torch.float32).mean()

    hist = []
    first_100 = None
    for e in range(epochs):
        train_p, l = step(train_p)
        if e % 50 == 0 or e == epochs - 1:
            acc = float(acc_fn(train_p))
            hist.append((e, float(l), acc))
            if first_100 is None and acc >= 0.999:
                first_100 = e
    n_params = sum(v.numel() for v in train_p.values())
    return hist, first_100, n_params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    ap.add_argument("--steps", type=int, default=2000,
                    help="training epochs of each method")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for method in ["lora", "fourierft"]:
        hist, first_100, n_params = train(method, device, epochs=args.steps)
        final = hist[-1]
        print(f"\n== {method} ({n_params} trainable params) ==")
        for e, l, a in hist[::4] + [final]:
            print(f"  epoch {e:5d}  loss {l:.4f}  acc {a:.3f}")
        print(f"  reached 100% at epoch: {first_100}")
        out[method] = {"hist": hist, "first_100": first_100,
                       "n_params": n_params}
    print("\nPaper claim (App. C.2): FourierFT overcomes the equal-budget "
          "LoRA bottleneck — compare the two 'reached 100%' lines above.")
    return out


if __name__ == "__main__":
    main()
