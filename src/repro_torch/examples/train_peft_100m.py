"""End-to-end run: instruction-tuning-style fine-tune of a
~100M-parameter LLaMA-shaped decoder with FourierFT — the paper's Table 4
setting at laptop scale (the JAX package's `examples/train_peft_100m.py`
on the port). Pre-trains the base on task A, fine-tunes adapters on task
B, with checkpointing and a LoRA comparison at the paper's parameter
ratio.

    PYTHONPATH=src python -m repro_torch.examples.train_peft_100m --steps 200
(defaults to a quick 40-step run; --steps 300+ reproduces the full curves;
--device cpu runs off the card; checkpoints go to a fresh temporary
directory per method)
"""
import argparse
import tempfile
import time

from repro_torch.configs.base import ModelConfig, PEFTConfig, TrainConfig
from repro_torch.data import SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.models import build
from repro_torch.train import loop
from repro_torch.train import step as train_step
from repro_torch.tree import tree_leaves

# ~100M params: 12L, d=768, llama-style (gated mlp, GQA 12/4)
CFG_100M = ModelConfig(
    name="llama-100m", family="dense", num_layers=12, d_model=768,
    n_heads=12, n_kv=4, head_dim=64, d_ff=2048, vocab=8192,
)


def run(method: str, steps: int, pretrained_base, data, device,
        kernel_backend: str = "auto"):
    peft = (PEFTConfig(method="fourierft", n=256, alpha=16.0,
                       kernel_backend=kernel_backend)
            if method == "fourierft"
            else PEFTConfig(method="lora", lora_r=8, lora_alpha=16.0,
                            kernel_backend=kernel_backend))
    model = build(CFG_100M, peft)
    # which kernel backend each adapted site's ΔW path resolved to (the
    # hand-written CUDA kernel on the card, the plain version on the CPU)
    print(model.explain_kernels(device))
    tcfg = TrainConfig(learning_rate=3e-3 if method == "lora" else 1e-2,
                       total_steps=steps, warmup_steps=max(steps // 10, 2))
    state, frozen = train_step.init_state(model, tcfg, 1, device)
    frozen = {"base": pretrained_base, "peft": frozen["peft"]}
    step_fn = train_step.make_train_step(model, tcfg)
    t0 = time.time()
    state, report = loop.run(
        step_fn, state, frozen, data, tcfg,
        ckpt_dir=tempfile.mkdtemp(prefix=f"repro_100m_{method}_"),
        ckpt_every=max(steps // 2, 10), log_every=max(steps // 8, 1))
    return {
        "trainable": model.trainable_params(),
        "first": report.losses[0], "final": report.final_loss,
        "wall_s": time.time() - t0, "anomalies": report.anomalies,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--pretrain-steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--kernel-backend", type=str, default="auto",
                    choices=["auto", "pallas", "einsum"],
                    help="ΔW kernel policy (kernels/api.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n_base = sum(x.numel() for x in tree_leaves(
        build(CFG_100M, PEFTConfig(method="none")).init_shapes()["base"]))
    print(f"base model: {n_base/1e6:.1f}M params")

    # pre-train the base briefly on the "pretraining" task
    base_model = build(CFG_100M, PEFTConfig(method="full"))
    btcfg = TrainConfig(learning_rate=3e-3, total_steps=args.pretrain_steps,
                        warmup_steps=5)
    bstate, bfrozen = train_step.init_state(base_model, btcfg, 0, device)
    bstep = train_step.make_train_step(base_model, btcfg)
    pre = SyntheticLM(vocab=CFG_100M.vocab, batch=args.batch, seq=args.seq,
                      task_seed=1)
    print(f"pre-training base for {args.pretrain_steps} steps ...")
    for i in range(args.pretrain_steps):
        batch = {k: v.to(device) for k, v in pre.batch_at(i).items()}
        bstate, m = bstep(bstate, bfrozen, batch)
    pretrained = bstate["trainable"]["base"]
    print(f"  pretrain loss -> {float(m['loss']):.3f}")
    del bstate, bfrozen

    # fine-tune on the downstream task with each method
    ft_data = SyntheticLM(vocab=CFG_100M.vocab, batch=args.batch,
                          seq=args.seq, seed=2, task_seed=42)
    results = {}
    for method in ["fourierft", "lora"]:
        print(f"\n== fine-tuning with {method} ==")
        results[method] = run(method, args.steps, pretrained, ft_data,
                              device, kernel_backend=args.kernel_backend)
        r = results[method]
        print(f"  trainable={r['trainable']:,}  loss {r['first']:.3f} -> "
              f"{r['final']:.3f}  ({r['wall_s']:.0f}s, "
              f"anomalies={r['anomalies']})")

    f, l = results["fourierft"], results["lora"]
    print(f"\nFourierFT used {f['trainable']/l['trainable']*100:.1f}% of "
          f"LoRA's parameters; final losses: fourier={f['final']:.3f} "
          f"lora={l['final']:.3f}")
    return results


if __name__ == "__main__":
    main()
