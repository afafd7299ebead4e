#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card
and hold its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit and
no result line:

1. device   — the card's name and power limit (nvidia-smi).
2. build    — nvcc builds every kernel of `src/repro_torch/kernels/csrc`
              (one process per source, started together).
3. K1       — the FourierFT ΔW kernel (FFT-structured: one transform of
              length d2 per pair of rows) against its plain version at the
              slices' shapes (yi-6b wq 4096x4096 and wv 4096x512, n = 1000,
              stacked over L = 2), one ragged shape and two shapes off the
              main path (qwen2.5-32b wq 5120x5120, radix 5; yi-6b's MLP
              4096x11008, radix 43), phase 16a's LLaMA2-7B q/v stack
              (4096x4096 over L = 32) and phase 18's families' q/v stacks
              (olmoe-1b-7b 2048x2048 over L = 16, phi3.5-moe's wv
              4096x1024 over L = 4, musicgen-medium 1536x1536 over L = 48,
              radix 3, qwen2-vl-72b 8192x8192 and 8192x1024 over L = 2)
              and phase 19's in/out projections (mamba2-2.7b 2560x5120 and
              5120x2560 over L = 64, radix 5; zamba2-7b 3584x7168 and
              7168x3584 over L = 81, radix 7), and qwen2-vl-72b's MLP up
              projection 8192x29568 over L = 2, past one block's 29056
              columns: each row pair on a cluster of two blocks (the plan's
              blocks a row checked at every shape, 1 up to 29056); each
              held, not summed into the kernels line, the families' listed
              in its `family_shapes`, the cluster's in `cluster_shapes`,
              atol 2e-4 and at most 1e-5 of the plain
              version's largest |value| at each shape (REL_TO_PLAIN), in
              f32 with TF32 off, the same bits on a second launch; kernel, plain, `torch.fft.ifft2`
              (the paper's Algorithm 1, the library call for the same
              function) and one-`torch.matmul` times, the kernel's time as
              a multiple of its bound and of the library call.
4. K2       — the dc kernel (K1's VJP) against its plain version at the
              same shapes (`family_shapes` and `cluster_shapes` too), atol
              2e-3 / rtol 1e-4
              (the JAX suite's dc tolerance) and at most 1e-5 of the plain
              version's largest |value|, f32 with TF32 off, the same bits on a second
              launch; kernel, plain and `torch.fft.fft2` (gathered at the
              entries) times and multiples as for K1.
              K1's and K2's bound is what the function needs (`fft_ops`):
              one pass over ΔW or g against the FFT formulation's
              operations; the direct sum (the earlier design of these
              kernels) has its own FP32 floor, still reported as
              `direct_sum_bound_ms`.
5. K3       — the paged decode attention kernel (split over pages)
              against its plain version at yi-6b geometry (H 32, K 4, dh
              128, page 16): B 8, W 1, kv_len 1..128 (the serving phases'
              shape, kept for comparison with earlier runs), B 8 ragged to
              1024 and to 4096, B 8 at 4096, B 32 at 2048 and a verify
              window W 5 at 4096; then at group size G = 1, LLaMA2-7B's
              (H = K = 32, dh 128) and GPT-2-medium's (H = K = 16, dh 64)
              geometry, B 8 at kv_len <= 128 and at 4096, and the MoE
              families' serving heads: olmoe-1b-7b (H = K = 16, dh 128,
              G = 1) and phi3.5-moe (H 32, K 8, G = 4), each at kv_len
              <= 128 (phase 18's serving) and 4096; bf16 and f32
              against the plain version
              in f32 on the same inputs (f32 atol = rtol = 1e-5; bf16 2e-2
              of each output vector's largest |value|, never beyond atol =
              rtol = 2e-2), the same bits on a second launch; kernel (CUDA events, page pools
              rotated past the L2), device (torch.profiler), plain and SDPA
              (on the pre-gathered window) times and the bound per shape.
6. gradient — ΔW of the wq and wv sites through the registry's CUDA op
              (the autograd Function: K1 forward, K2 backward), a vdot
              against a fixed cotangent, `.backward()`: c.grad exists,
              equals the einsum path's autograd gradient within the K2
              tolerance, and K2 launched once per site.
7. serve    — yi-6b at full width, cut to SLICE_LAYERS layers, bf16,
              FourierFT n = 1000, alpha = 300 on wq/wv: Engine (merge ->
              K1) and ContinuousScheduler (paged -> K3) replay the
              launcher's 8-request staggered trace. Every request completes
              its budget, logits are finite, the launch counters show K1
              and K3 ran (K3 exactly decode steps x layers), and the same
              trace with kernel_backend="einsum" gives merged weights
              within one bf16 ulp and the same first token for every
              request.
8. train    — the same model trained TRAIN_STEPS steps through
              `make_train_step` (SyntheticLM batch 8 x seq 64, microbatch
              2, lr 1e-2, warmup 1): losses finite, no anomaly, c moved,
              K1 and K2 each launched steps x microbatches x 2 sites; the
              same steps with kernel_backend="einsum" track the losses and
              the coefficients' movement, and the whole model's gradient
              w.r.t. c at the first batch, in f32, matches the einsum
              path's, within the tolerances stated there; cold and warm ms
              per step and tokens/s.
9. K4       — the DCT ΔW kernel (FFT-structured on K1's passes: one
              transform of length d2 per pair of rows) against its plain
              version at K1's shapes (the main ones, the ragged one,
              5120x5120, 4096x11008 and the cluster's 8192x29568), atol
              2e-5 / rtol 1e-5 (the JAX suite's site_delta tolerance) and
              at most REL_TO_PLAIN of the plain version's largest |value|
              (recorded with each cluster shape), f32 with TF32 off, the same
              bits on a second launch; kernel, plain and one `torch.matmul`
              of the prebuilt (C1 ⊙ c)·C2ᵀ factors (the library call)
              times; the bound is `fft_ops`'s (a fast 2-D DCT costs what a
              real FFT does), the direct sum's FP32 floor (2·d1·d2·n·L)
              is `direct_sum_bound_ms`.
10. K5      — the DCT dc kernel (K4's VJP, on K2's passes) at the same
              shapes, atol 1e-4 / rtol 1e-3 (the JAX suite's gradient
              tolerance) and at most REL_TO_PLAIN of the plain version's
              largest |value|, bit-identical on a second launch; kernel, plain
              and `torch.matmul(g, C2)` on prebuilt bases (then the
              C1-weighted row sum) times, bounds as for K4.
11. dct gradient — phase 6 for the `dct` method: c.grad through the
              registry's CUDA op (K4 forward, K5 backward) equals the einsum
              path's autograd gradient within K5's tolerance, K5 launched
              once per site.
12. dct     — the path of the `dct` method on phase 7's model (yi-6b full
              width, SLICE_LAYERS layers, bf16, n = 1000, alpha = 300 on
              wq/wv): TRAIN_STEPS steps through `make_train_step` (phase 8's
              batches and schedule; losses finite, no anomaly, c moved, K4
              and K5 each launched steps x microbatches x 2 sites), then the
              trained params merged with K4 and served through
              ContinuousScheduler on the launcher's trace (K3): every
              request completes, K4 launched once per site, K3 decode steps
              x layers, and the einsum merge of the same params gives
              merged weights within one bf16 ulp. First tokens: the same
              coefficients merged into the model in f32 by K4 and by the
              einsum path give the same first token for every prompt; the
              bf16 runs' first tokens are reported with each prompt's top-2
              logit margin (bf16 logits can tie exactly, and a one-ulp
              difference then decides the argmax).
13. bank    — multi-tenant serving over the clean base: yi-6b at full
              width, SLICE_LAYERS layers, f32; five tenants (fourierft and
              dct n = 1000, alpha = 300; lora r = 8; circulant alpha = 300;
              bitfit) on wq/wv, seeded and scaled so each moves tokens,
              exported with checkpoint/adapters and served by
              ContinuousScheduler (paged -> K3) from an AdapterBank of
              capacity 3 over the launcher's 12-request trace cycling the
              tenants and None (so LRU evictions and checkpoint reloads
              happen mid-trace, live tenants pinned). Every request
              completes its budget, K3 launches decode steps x layers, the
              bank loads at least 6 times; a None request's tokens and
              logits are bitwise the bare base's; every request's first
              token equals its serial Engine.generate; the FourierFT
              tenant's bank_apply at wq (4096x4096) and wv (4096x512)
              equals x @ K1's ΔW (atol 1e-6 x max |y|, rtol 5e-4); and
              generate_requests with an EOS id makes exactly as many decode
              calls as the EOS step. Then the median decode-step time (bf16,
              8 slots) of the bank engine against the merged one-adapter
              engine at SLICE_LAYERS and 32 layers, in turns, the bank
              step's device-busy share (torch.profiler) and the bytes of
              the frozen tables the bank built once.
14. spec    — speculative decoding and the dense per-slot cache on phase
              7's model in f32 (TF32 off), FourierFT merged by K1, 8 slots,
              page 16, the launcher's trace: the self-drafter (k = 4: K3 at
              W 1 for its probes and W 5 to verify) and the n-gram drafter
              (k = 4: K3 at W 5 only) give the plain scheduler's streams,
              the self-drafter more than one token per slot-step, and K3
              launches exactly layers x verify steps at W 5 (x k more at
              W 1 for the self-drafter); the dense cache (paged=False,
              self k = 3) gives the same streams with no K3 launch; an EOS
              inside the window (a token the plain run emits early) stops
              the same requests at the same tokens; phase 13's tenants and
              None over a bank of capacity 3 with the self-drafter (k = 3)
              give the plain bank scheduler's streams, the None requests
              the bare base's. K3 at the speculative path's shapes (8
              slots, page 16, 8 pages a slot, W 4 and W 5, positions ragged
              to 125, one window past the block table) inside
              `verify_logits`, in f32 and then in bf16 at each timed depth:
              every layer's K3 output within pak.agreement_limit of the
              plain version on the same inputs, the logits within those of
              the forward on the plain version (f32 atol = rtol = 1e-4 and
              the same tokens; bf16 5e-2 of a row's largest |logit| at
              SLICE_LAYERS, reported at 32 layers, where bf16 rounding
              compounds over depth). Then
              in bf16 at SLICE_LAYERS and 32 layers:
              the trace's tokens/s plain, self and n-gram (two runs each, in
              turns), tokens per slot-step, acceptance, the share of tokens
              equal to the plain run's (bf16 logits can tie: reported, not
              required), and one decode step, one verify step (W 5) and
              one self-drafter step (4 probes + verify) alone at kv_len
              101, wall and device time (torch.profiler).
16. paper   — the paper's own surface. (a) LLaMA2-7B at full size (32
              layers, d 4096, 32 heads of 128 with no GQA, d_ff 11008,
              vocab 32000, bf16, FourierFT n = 1000, alpha = 300 on wq/wv):
              Table 1 first (64,000 trainables, 264,000 storage bytes,
              LoRA r = 64's 33,554,432 beside them); 4 steps through
              `make_train_step` (batch 8 x seq 64, microbatch 2): losses
              finite, no anomaly, c moved, K1 and K2 each launched steps x
              microbatches x 2 sites, cold and warm ms per step, tokens/s,
              peak memory; the train state freed, the trained params merged
              by K1 (2 launches) and the launcher's 8-request trace served
              by ContinuousScheduler on the paged cache: every request
              completes, K3 launches decode steps x 32, the einsum merge
              within one bf16 ulp of K1's; then one decode step alone (8
              slots) at kv_len 101 and 4096: wall, device time and K3's
              share at G = 1. (b) The Table-6 bases at roberta-base
              geometry (12 layers, d 768, MHA dh 64, non-gated, no RoPE,
              f32): random n = 1000 and orthogonal n = 768 resolve their
              ΔW to the torch.matmul route, equal the same product in
              float64 within atol 2e-5 / rtol 1e-4 at every site (the
              einsum op runs the same function as the route), merge and
              train 3 steps
              (c moves) with no K1 or K2 launch. (c) `full` on gpt2-medium
              (24 layers, d 1024, bf16): 3 steps, losses finite, every
              base leaf moves, no kernel launches. (d) `--strategy
              factored` on phase 7's model: 3 steps with no kernel launch,
              c moves, and the f32 gradient w.r.t. c at the first batch
              equals the merged step's (K1/K2) within 1e-4 of the
              gradient's size: norm-relative, and each entry against
              max |g|. The phase is `chip_smoke.paper_phase`,
              rehearsable on the CPU at reduced configs with the CUDA
              routes resolved for CPU tensors and counting wrappers.
17. tiering — tiered serving, cancellation and the gateway on phase 7's
              model in f32 (TF32 off), FourierFT merged by K1, page 16,
              max_len 128. (a) Preempt and resume: two long `batch`
              requests own a pool of 8 pages (3 slots) and three
              `interactive` arrivals must preempt them, under mode swap
              (host pool of 64 pages), recompute and auto: every stream
              equals the same trace served without tiering on an
              unconstrained pool, every swap-resume's filled pages equal
              the pages its preemption gathered, bitwise, read back right
              after the fill; K3 launches decode steps x layers; no page
              leaked, no snapshot left; at least one swap, one recompute
              and one resume over the runs. (b) Host tiers: a shared
              33-token prompt's two cached chunks demote to the host
              under page pressure and come back (prefix host hits >= 1),
              the streams those of an unconstrained run; phase 13's five
              tenants and None over a bank of capacity 2 with a host tier
              of 5 rows give the streams of a capacity-5 bank, with at
              least one host hit and every host reload bitwise its
              checkpoint. (c) Cost: spill + fill of 8 pages through pinned
              memory against a prefill of the same 128 tokens, in turns
              (medians), as the card's counterpart of
              `TieringConfig.swap_cost_per_token`. (d) The gateway
              (`GatewayServer` on 127.0.0.1, port 0) over a scheduler
              built by `launch.api.build_scheduler` from flags (the same
              model and depth, f32, 4 slots, `--preempt --preempt-mode
              swap --host-kv-pages 64`), its pump thread driving the card:
              the launcher's 8-request trace as streaming
              /v1/completions, then, with every slot decoding, two
              `interactive` streaming /v1/chat/completions (the stdlib
              asyncio client): every stream equals an in-process `serve()`
              of a scheduler built from the same flags; a client that
              leaves mid-stream is cancelled and no page leaks; /metrics
              shows the preemptions and the host-tier gauges; K3 launches
              decode steps x layers, on the pump thread only. The phase
              is `chip_smoke.tiering_phase`, rehearsable on the CPU at a
              reduced config with a counting stand-in for K3 and the K1
              wrapper counted.
18. families — long sequences and the transformer's other families.
              (a) Attention alone at yi-6b's heads (H 32, K 4, dh 128), B 1,
              S 4096, bf16 and f32: `flash_attention`'s forward and its
              recomputing backward, and `chunked_attention`, against
              float64 `direct_attention` on the same inputs under
              autograd: f32 at the CPU suite's tolerances (forward 3e-6,
              each gradient 5e-5, chunked 2e-5); bf16 each tensor against
              its own size (every output vector within 6e-3 of its largest
              |value|, flash's and chunked's; each gradient ||diff|| / ||g||
              <= 2.5e-3 and max |diff| / max |g| <= 2e-2), the same
              readings against the f32 problem before the bf16 rounding
              printed as the control the limits must stay below; ms per
              call and
              peak memory above the inputs for flash, chunked, direct and
              SDPA (the library call for the same causal GQA product, not
              on the port's path), forward and forward+backward, and the
              bound (the causal product's operations at the dtype's rate
              or its bytes at the HBM rate); flash's peak must be below
              direct's. (b) olmoe-1b-7b at full size
              (16 layers, d 2048, 64 experts top-8, bf16, FourierFT
              n = 1000, alpha = 300 on wq/wv): 3 merged train steps at
              B 1 x S 4096 through flash (K1/K2 at L 16, 2048x2048; losses
              finite, no anomaly, c moved, K1/K2 2 a step, flash once a
              layer a step), flash's share of the warm step, then the
              merge (K1 2) and 6 requests through ContinuousScheduler on
              the paged cache (K3 at G = 1, decode steps x 16); on a
              2-layer full-width f32 copy the kernel path's streams equal
              the plain path's. (c) phi3.5-moe at full width cut to 4 of
              its 32 layers (84 GB in bf16 does not fit one card): 3 steps
              at S 2048, then the same serving with K3 at G = 4. (d)
              musicgen-medium at full size (48 layers): 3 steps on
              4-codebook batches (B 2 x S 2048, K1/K2 at 1536x1536, radix
              3), the merge, and lockstep Engine.generate of (16, 4)
              streams. (e) qwen2-vl-72b at full width cut to 2 of its 80
              layers: 2 steps on an embeds batch with (3, B, S) M-RoPE
              positions at S 2048 (flash; K1/K2 at 8192x8192 and
              8192x1024), the merge, a prefill of the embeddings and one
              decode_step; FourierFT there on wq, wv and the MLP's up
              projection wi (8192x29568: K1/K2 over a cluster of two
              blocks; the gate projection wg is no adapter site), K1 = K2
              = 3 a step (1 over a cluster) and the merge's K1 3; then the
              dct method on the same sites and base, 2 steps (K4 = K5 = 3
              a step, 1 over a cluster) and K4's merge. Each of (b)-(e)
              prints its warm ms per step,
              tokens/s and peak memory. The phase is
              `chip_smoke.families_phase`, rehearsable on the CPU at
              reduced configs (S 1536) with the CUDA routes resolved for
              CPU tensors, counting wrappers and the memory readers
              stubbed.
19. ssm     — the pure-SSM and hybrid families, bf16 unless noted,
              FourierFT n = 1000, alpha = 300. (a) The SSD scan alone at
              mamba2-2.7b's geometry (H 80, P 64, N 128, G 1, chunk 256,
              B 1, S 4096) and at zamba2-7b-instruct's (H 112, N 64, G 2),
              x, B and C in bf16 (as the models run it) and in f32:
              `ssd_chunked` and the kernel (`kernels/ssd_scan.py`,
              through `mamba2.ssd_scan`'s route: 2 forward calls and 1
              backward by its counters) each against
              `ssd_recurrent_oracle` in float64 on the same values, y and
              the final state each within 1e-4 of its own largest |value|
              (the CPU suite's 1e-4, whose tensors are of order 1; a bf16
              output first allowed the half ulp of its own rounding, 2^-8
              of the value, as the card tests do), the gradients w.r.t.
              x, dt, B and C against float64 autograd of the scan at the
              same limit, the f32 oracle's reading printed as the
              control; forward and forward+backward ms of both, peak
              memory above the inputs and the bounds at the FP32 rate or
              the HBM rate (the plain version's: the chunked algorithm's
              operations, every (Q, Q) square whole; the kernel's: the
              causal work of its own decomposition, chunks of 64 rows);
              the kernels line's `ssd_scan` entry (bf16 at
              zamba2-7b-instruct's geometry, and the calls of (b) and
              (c)'s train steps).
              (b) mamba2-2.7b at full size (64 layers, d 2560, vocab
              50280) on its default targets, which resolve to wx/wo_ssm
              (K1/K2 at 2560x5120 and 5120x2560 over L 64), remat full: 6
              merged train steps at B 1 x S 2048 (losses finite, no
              anomaly, c moved, K1 and K2 2 a step, the SSD scan kernel
              128 forward calls a step (each layer's forward and its
              recompute) and 64 backward), the warm step the
              median of the last 5 with their range, the scan's share of
              it; the merge (K1 2) and lockstep Engine.generate
              of 4 prompts x 16 tokens through the recurrent prefill with
              no K3 launch; ContinuousScheduler raises
              NotImplementedError; on a 2-layer full-width f32 copy the K1
              merge is within one f32 ulp of the merged value plus 1e-5 of
              the layer's largest |ΔW| of the plain path's
              (`merged_f32_close`), and the streams equal. (c) zamba2-7b at full size (81 layers, 14
              shared-block applications) with FourierFT on wq, wv, wx and
              wo_ssm, remat full: 6 merged train steps at B 1 x S 2048
              (flash once an application a step, once more for each of
              the 13 checkpointed groups' recompute; K1/K2 2 a step on the
              mamba sites (3584x7168, 7168x3584, radix 7), none on
              shared/*; the SSD scan kernel 81 + 78 forward calls a step
              (the 78 layers of the full groups recomputed) and 81
              backward); the merge leaves shared/* factored under
              fourierft and folds layers/*; generate as in (b); one
              decode_step alone at max_len 4096, pos 4095: wall and
              device time and the 14 direct attentions' share; on an f32
              copy of one full group and the tail (7 layers) the merge is
              held as in (b) and the kernel path's streams equal the plain
              path's. Each of (b) and (c)
              prints cold and warm ms, tokens/s and peak memory. The
              phase is `chip_smoke.ssm_phase`, rehearsable on the CPU at
              reduced configs as phase 18 is.
20. analysis — the static analyzer (`repro_torch.analysis`) on the card:
              (a) `kernel_audit.run()` and `audit_device` (every
              shared-memory request against the card's opt-in shared
              memory per block, printed), then K1/K2 and K4/K5 at the
              edges their `accepts` admits (d2 = the largest width <=
              MAX_D2 with odd prime factors <= MAX_RADIX, d1 = MAX_D1,
              n = MAX_N; L 1) and K3 at head_dim 256 in bf16 and f32, each
              held to its plain version at phases 3-5's and 9-10's
              tolerances and bitwise on a second launch; one shape past
              each limit refused at resolution (and by the wrappers),
              naming the limit. (b) the dispatch lint at full width
              (yi-6b, bf16, FourierFT n 1000, α 300 on wq/wv): 3 train
              steps of 2 x 64 at SLICE_LAYERS (K1/K2 2 a step) and phase
              7's trace through the paged scheduler at all 32 layers (K3 =
              decode steps x 32), host transfers a step with the ops and
              source lines behind them, the same rounds counted by
              `torch.cuda.set_sync_debug_mode("warn")` (they must agree),
              the findings gated against the committed baseline. (c)
              `python -m repro_torch.launch.serve --arch yi-6b
              --continuous --analyze` in a subprocess: exit 0, `analyze:
              recompile audit clean` and the signature counts. The phase
              is `chip_smoke.analysis_phase`, rehearsable on the CPU at
              reduced configs
              (tests/test_torch_analysis.py::test_analysis_phase_rehearses_on_the_cpu).
21. mesh    — the placement layer and the sharded paths at full width
              (yi-6b, 32 layers, bf16, FourierFT n 1000, alpha 300 on
              q/v), each launcher in a subprocess. (a) `torchrun
              --nproc-per-node 1 -m repro_torch.launch.train
              --model-parallel 1 --grad-compression int8_ef
              --sharding-plan search`, 5 steps of 8 x 64 on NCCL through
              DTensors: K1 and K2 launch (the launcher's counts), the
              losses and the trained |c| of each site equal to those of
              the same run without torchrun (plain tensors), and the warm
              step (median of 4) both ways; then both runs again at
              `--microbatch 2` (3 steps): losses and |c| equal (the
              placed batch's rows ordered so that the DTensor step's
              every-other-row split is the plain step's two halves,
              `train.step.place_batch`), K1 = K2 = steps x 2 x 2. (b) `torchrun
              --nproc-per-node 1 -m repro_torch.launch.serve --continuous
              --sharding-plan search` on an 8-request trace: K1 merges and
              K3 runs on the local shards, the streams equal the plain
              path's. (c) The planner at production scale: yi-6b on the
              abstract 16x16 mesh for train_4k, on meta tensors and the
              card's constants: the winner's predicted cost, at or below
              the rules'. Two ranks cannot share the one card (NCCL
              refuses a duplicate device; over gloo a rank dies with
              SIGSEGV, `tools/probe_shared_card.py`), so multi-rank runs
              are the CPU tests'; (d) makes in process the kernel calls a
              rank of a 1x2 model-parallel mesh makes: K2 on each
              zero-padded half of a column-sharded cotangent at wq and wv
              (the halves summed equal K2 of the whole), K3 on half the
              query and KV heads (side by side equal to the whole heads'),
              each held to its plain version (`tp2_local_checks`). The
              phase is `chip_smoke.mesh_phase`.
22. families mesh — every family, the bank and the gateway on the mesh
              path, one rank under `torchrun` (NCCL, DTensors) against
              the same run without a process group. (a) olmoe-1b-7b at
              full size, 3 train steps of 1 x 2048: losses and each
              site's trained |c| bitwise the plain run's, K1 = K2 = 2 a
              step; the 8-request continuous trace: streams equal, K3 =
              steps x 16. (b) mamba2-2.7b at full size (remat full), 2
              steps of 1 x 2048, the same equalities; lockstep serving,
              streams equal. (c) Phase 13's five tenants on the DTensor
              engine of a one-rank group in process: streams equal the
              plain bank's. (d) `launch.api` under `torchrun
              --nproc-per-node 1` through the broadcast pump: the HTTP
              streams equal the in-process replay. (e) A 1x2 rank's
              calls in process: K2 on each zero-padded half of
              mamba2's wx/wo_ssm cotangents (halves summed against the
              whole), K3 on olmoe's 8 of 16 heads (the halves side by
              side bit-identical to the whole heads'). (f) The
              production dry run, each cell `launch.dryrun` in its own
              process on the card route (fake 16x16 group): yi-6b
              train_4k and decode_32k, olmoe-1b-7b train_4k, and yi-6b
              train_4k with the searched plan, whose collective bytes
              must not exceed the rules'; started first, they run on
              the host while (a)-(e) use the card. The phase is
              `chip_smoke.families_mesh_phase`.
23. entry points — the repository's remaining entry points on the port.
              (a) `python -m repro_torch.launch.api` in a subprocess
              (yi-6b at full width, SLICE_LAYERS layers, f32, the demo
              bank's two tenants, port 0) driven by
              `repro_torch.launch.loadgen` in process: 48 requests at 16
              req/s over base, adapter:t0 and adapter:t1 (Zipf 1.2, shared
              prefix 0.5, interactive 0.25 / batch 0.75, 16 new tokens),
              `--verify`: every stream bit-identical to the in-process
              replay of a scheduler built from the same flags, whose K3
              launches are its decode rounds x layers; TTFT p50
              and p99, inter-token p50, tokens/s and the 429s printed with
              the card's name and power limit. (b) The four examples of
              `repro_torch.examples` at their own sizes, in process:
              quickstart's loss falls over its 200 steps and its merged
              engine generates 12 tokens a prompt; serve_batched serves
              three tenants; train_peft_100m pre-trains and fine-tunes both
              methods; expressiveness_2d prints both methods' final
              accuracy and their "reached 100%" lines. The phase is
              `chip_smoke.entry_points_phase`, rehearsable on the CPU
              (`model_flags` with `--reduced --device cpu`, `example_args`
              `--device cpu --steps N`, nvidia-smi stubbed and K3 counted
              by a stand-in).
15. kernels — one JSON line with each kernel's launches (by path, phases
              16's to 23's included; K1/K2/K4/K5's launches over a cluster
              of two blocks as `cluster_train` and `cluster_merge`, their
              cluster shapes as `cluster_shapes`), error and times;
              printed last.

The last line is {"ok": true, "device": {...}}. The script imports nothing
of JAX; it needs a CUDA device and the repository's `src/` beside it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

H100_HBM_BYTES_PER_S = 3.35e12        # NVIDIA H100 SXM data sheet
H100_PEAK = {"float32": 67e12,        # FP32 outside the tensor cores
             "bfloat16": 989e12}      # dense bf16 tensor-core rate
SLICE_LAYERS = 2                      # depth cut of yi-6b (time, not memory)
TRAIN_STEPS_19 = 6                    # phase 19's train steps: 1 cold, 5 warm
# K1/K2/K4/K5 are also held to this share of the plain version's largest
# |value| at each shape (about 84 f32 ulps of it): a ΔW whose scale is off
# by 1e-3 or that has one coefficient at a wrong frequency exceeds it
REL_TO_PLAIN = 1e-5
TRAIN_STEPS, MICROBATCH = 6, 2
# what torch.cuda.set_sync_debug_mode("warn") says at each synchronizing
# operation (its one-time notice that the mode is a prototype is not one)
SYNC_WARNING = "called a synchronizing CUDA operation"
MESH_STEPS = 5                        # phase 21's train steps: 1 cold, 4 warm
MESH_MB_STEPS = 3                     # phase 21a's steps at microbatch 2


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / H100_PEAK[dtype]
    t_mem = nbytes / H100_HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def fft_ops(d1: int, d2: int, L: int) -> float:
    """Operations of the FFT formulation of K1's, K2's, K4's and K5's
    functions: a real-data 2-D FFT (or DCT, which a real FFT of the same
    size computes) of d1 x d2 points per layer, 2.5·N·log2 N for
    N = d1·d2 (half the 5·N·log2 N of a complex transform). No known
    method needs fewer; the direct sum needs 4·d1·d2·n (2·d1·d2·n for
    the cosine-only DCT)."""
    size = float(d1 * d2)
    return 2.5 * size * math.log2(size) * L


def padded_entries(entries, n: int, nc: int):
    """(2, n) entries zero-padded to a multiple of the kernels' chunk `nc`
    -> (u, v) contiguous int32 on the entries' device."""
    import torch
    npad = -(-n // nc) * nc
    e = torch.zeros((2, npad), dtype=torch.int32, device=entries.device)
    e[:, :n] = entries
    return e[0].contiguous(), e[1].contiguous()


def merged_within_one_ulp(w, a, b):
    """Both merges add bf16(ΔW) to the same bf16 W: the f32 ΔWs agree to
    far below bf16's resolution, but casting them to bf16 can still differ
    in the last bit, and the sum then rounds once more. Allowed: one bf16
    ulp (2^-7 relative) of the merged value plus one of ΔW. Returns
    (ok, number of values that differ)."""
    import torch
    w, a, b = w.float(), a.float(), b.float()
    ulp = (torch.maximum(a.abs(), b.abs())
           + torch.maximum((a - w).abs(), (b - w).abs())) * 2.0 ** -7
    diff = (a - b).abs()
    return not bool((diff > ulp).any()), int((diff > 0).sum())


def merged_f32_close(w, a, b):
    """Two f32 merges of the same (L, d1, d2) W, by K1 (`a`) and by the
    plain path (`b`): each sum rounds once, so they may differ by one f32
    ulp of the merged value, and the two ΔWs by REL_TO_PLAIN of each
    layer's largest |ΔW| (phase 3's limit). Returns (ok, the largest
    |a - b| as a share of its limit)."""
    import torch
    dw = (b - w).abs().amax(dim=(-2, -1), keepdim=True)
    limit = (torch.maximum(a.abs(), b.abs()) * 2.0 ** -23
             + REL_TO_PLAIN * dw)
    share = float(((a - b).abs() / limit).max())
    return share <= 1.0, share


class PhaseError(RuntimeError):
    """A check of a phase failed: the message says which."""


def zero_counts():
    """Sets every kernel wrapper's launch count to 0 (K3's by window width,
    K1/K2/K4/K5's over a cluster of blocks too, the fused attention's and
    the SSD scan's forward and backward)."""
    from repro_torch.kernels import dct_deltaw as ddk
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import fused_attention as fak
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import ssd_scan as ssk
    fdk.launches = fdk.dc_launches = ddk.launches = ddk.dc_launches = 0
    fak.launches = fak.bwd_launches = 0
    ssk.launches = ssk.bwd_launches = 0
    fdk.cluster_launches = fdk.cluster_dc_launches = 0
    ddk.cluster_launches = ddk.cluster_dc_launches = 0
    pak.launches, pak.launches_by_w = 0, {}


def launch_counts() -> dict:
    """Each kernel's launches since the last `zero_counts()`; K1c, K2c,
    K4c and K5c count those of them over a cluster of two blocks, FA and
    FAb the fused attention's forward and backward launches, SSD and SSDb
    the SSD scan's forward and backward calls."""
    from repro_torch.kernels import dct_deltaw as ddk
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import fused_attention as fak
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import ssd_scan as ssk
    return {"K1": fdk.launches, "K2": fdk.dc_launches, "K3": pak.launches,
            "K4": ddk.launches, "K5": ddk.dc_launches,
            "FA": fak.launches, "FAb": fak.bwd_launches,
            "SSD": ssk.launches, "SSDb": ssk.bwd_launches,
            "K1c": fdk.cluster_launches, "K2c": fdk.cluster_dc_launches,
            "K4c": ddk.cluster_launches, "K5c": ddk.cluster_dc_launches}


def synthetic_batches(dev, cfg, B: int, S: int, n: int) -> list:
    """The first n `SyntheticLM` batches of B x S tokens (over
    cfg.n_codebooks codebooks when it has them), on `dev`."""
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(vocab=cfg.vocab, batch=B, seq=S, seed=0, task_seed=7,
                       codebooks=cfg.n_codebooks)
    return [{k: t.to(dev) for k, t in data.batch_at(i).items()}
            for i in range(n)]


def checked_steps(model, tcfg, params, bs, label: str, sync):
    """(state, frozen, losses, seconds per step) of len(bs) steps through
    make_train_step, each ending in the loss's read and `sync()`; raises
    PhaseError, naming `label`, on a non-finite loss or an anomalous
    step."""
    from repro_torch.train import step as train_step
    state, frozen = train_step.state_from_params(model, params)
    step = train_step.make_train_step(model, tcfg)
    losses, secs = [], []
    for b in bs:
        t0 = time.perf_counter()
        state, metrics = step(state, frozen, b)
        losses.append(float(metrics["loss"]))
        sync()
        secs.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses):
        raise PhaseError(f"{label}: non-finite loss {losses}")
    if int(state["anomalies"]) != 0:
        raise PhaseError(f"{label}: {int(state['anomalies'])} anomalous "
                         "steps")
    return state, frozen, losses, secs


def c_moved(state, params) -> bool:
    """Whether every site's coefficients in the train state differ from
    the ones it started from."""
    import torch
    return all(not torch.equal(state["trainable"]["peft"][s_]["c"], ad["c"])
               for s_, ad in params["peft"].items())


def counted_train(tag: str, name: str, model, params, bs, want_flash: int,
                  sync, sites: int = 2, cluster_sites: int = 0,
                  scan_calls=None):
    """`checked_steps` (lr 1e-2, warmup 1) with the kernels' launches and
    `flash_attention`'s calls counted: raises PhaseError, naming
    `tag` and `name`, unless c moved, the method's ΔW kernel and its VJP
    (K1/K2, K4/K5 for dct) each launched `sites` times a step (one per
    merged site), `cluster_sites` of them over a cluster of two blocks,
    flash ran `want_flash` times, the fused attention kernel (S <=
    1024 only) did not launch where flash ran, and, where `scan_calls`
    (forward, backward) is given, the SSD scan kernel was called that
    often a step (so no step ran `ssd_chunked` on the card in its place,
    nor the kernel more often). The warm time is the
    median of the steps after the first, printed with their range.
    Returns (state, frozen, figures, launch counts)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import attention as attn
    flash_calls = [0]
    flash_fn = attn.flash_attention

    def counting_flash(*a, **kw):
        flash_calls[0] += 1
        return flash_fn(*a, **kw)

    tcfg = TrainConfig(learning_rate=1e-2, total_steps=len(bs),
                       warmup_steps=1)
    zero_counts()
    attn.flash_attention = counting_flash
    torch.cuda.reset_peak_memory_stats()
    try:
        state, frozen, losses, secs = checked_steps(
            model, tcfg, params, bs, f"{tag} {name} train", sync)
    finally:
        attn.flash_attention = flash_fn
    got = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ref = bs[0].get("tokens", bs[0].get("embeds"))
    B, S_ = int(ref.shape[0]), int(ref.shape[1])
    if not c_moved(state, params):
        raise PhaseError(f"{tag} {name} train: c never moved")
    kf, kb = ("K4", "K5") if model.peft.method == "dct" else ("K1", "K2")
    if got[kf] != sites * len(bs) or got[kb] != sites * len(bs) \
            or got[kf + "c"] != cluster_sites * len(bs) \
            or got[kb + "c"] != cluster_sites * len(bs):
        raise PhaseError(f"{tag} {name} train: {kf} launched {got[kf]} "
                         f"({got[kf + 'c']} over a cluster), {kb} "
                         f"{got[kb]} ({got[kb + 'c']}); expected {len(bs)} "
                         f"steps x {sites} sites ({cluster_sites} over a "
                         "cluster)")
    if scan_calls is not None and (got["SSD"], got["SSDb"]) != (
            scan_calls[0] * len(bs), scan_calls[1] * len(bs)):
        raise PhaseError(f"{tag} {name} train: the SSD scan kernel was "
                         f"called {got['SSD']} forward, {got['SSDb']} "
                         f"backward; expected {len(bs)} steps x "
                         f"{scan_calls[0]} / {scan_calls[1]}")
    if flash_calls[0] != want_flash:
        raise PhaseError(f"{tag} {name} train: flash_attention ran "
                         f"{flash_calls[0]} times, expected {want_flash}")
    if want_flash and (got["FA"] or got["FAb"]):
        raise PhaseError(f"{tag} {name} train: the fused attention kernel "
                         f"launched {got['FA']} forward, {got['FAb']} "
                         f"backward beside flash's {want_flash} calls")
    warm = sorted(1e3 * t for t in (secs[1:] or secs))
    warm_ms = statistics.median(warm)
    fig = {"losses": losses, "cold_ms": secs[0] * 1e3, "warm_ms": warm_ms,
           "warm_min_ms": warm[0], "warm_max_ms": warm[-1],
           "tokens_per_s": B * S_ / warm_ms * 1e3, "peak_gib": peak,
           "batch": B, "seq": S_, "flash_calls": flash_calls[0],
           "fused_launches": [got["FA"], got["FAb"]]}
    print(f"[{tag}] {name} train: {len(bs)} steps of batch {B} x seq {S_}: "
          f"losses {[round(x, 4) for x in losses]} | {kf} {got[kf]}, {kb} "
          f"{got[kb]} launches ({got[kf + 'c']}, {got[kb + 'c']} over a "
          f"cluster), flash_attention {flash_calls[0]} calls, fused "
          f"attention {got['FA']} + {got['FAb']} backward, SSD scan "
          f"{got['SSD']} + {got['SSDb']} backward | "
          f"cold {secs[0] * 1e3:.1f} ms, warm median {warm_ms:.1f} ms/step "
          f"of {len(warm)} ({warm[0]:.1f}-{warm[-1]:.1f}; "
          f"{fig['tokens_per_s']:.0f} tokens/s) | peak device memory "
          f"{peak:.2f} GiB")
    return state, frozen, fig, got


def device_ms(fn, n: int):
    """(device ms per call, device kernels per call, the three kernels that
    take most device time as (name, ms per call)) of `fn` from
    torch.profiler; (None, None, []) when the trace shows no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [(ev.key, getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0)),
            ev.count) for ev in prof.key_averages()]
    evs = [e for e in evs if e[1] > 0]
    tot = sum(t for _, t, _ in evs)
    if tot <= 0:
        return None, None, []
    top = sorted(evs, key=lambda e: -e[1])[:3]
    return (tot / n / 1e3, sum(c for _, _, c in evs) / n,
            [(k_.replace("(anonymous namespace)::", "").split("(")[0][:60],
              t / n / 1e3) for k_, t, _ in top])


def k3_device_ms(fn, n: int):
    """Device ms per call of `fn` spent in K3's kernels (split and
    combine), from torch.profiler; None when the trace shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    tot = sum(getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
              for ev in prof.key_averages()
              if "paged_attn" in ev.key or "combine_splits" in ev.key)
    return tot / n / 1e3 if tot > 0 else None


def bank_tenants(dev, bmodel, bparams, tenant_dir: Path):
    """Phase 13's five tenants (fourierft and dct n = 1000, alpha = 300;
    lora r = 8; circulant alpha = 300; bitfit) on wq/wv of `bmodel`,
    seeded and exported to `tenant_dir` (emptied first). Returns (the
    bank's profiles by method, the tenant ids)."""
    import shutil
    import torch
    from repro_torch.checkpoint import adapters as adapter_ckpt
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.core import adapter as adapter_api
    from repro_torch.core import peft as peft_mod
    bank_profiles = {
        "fourierft": PEFTConfig(method="fourierft", n=1000, alpha=300.0),
        "dct": PEFTConfig(method="dct", n=1000, alpha=300.0),
        "lora": PEFTConfig(method="lora", lora_r=8),
        "circulant": PEFTConfig(method="circulant", alpha=300.0),
        "bitfit": PEFTConfig(method="bitfit"),
    }
    tenant_ids = [f"t-{m}" for m in bank_profiles]
    site_by_name = {s_.name: s_ for s_ in bmodel.sites}
    shutil.rmtree(tenant_dir, ignore_errors=True)

    def moving_tenant(mname: str, prof, seed: int):
        """Seeded trainables scaled so that each site's ΔW has half the
        Frobenius norm of its weight stack (BitFit: a bias of half the size
        of a unit-RMS input's projection), so every tenant moves tokens."""
        m_ = adapter_api.resolve(mname)
        g_ = torch.Generator(device=dev)
        g_.manual_seed(seed)
        tree = peft_mod.init_adapters(g_, bmodel.sites, prof, dev)
        names = m_.trainable_leaves(prof)
        out = {}
        for sname, ad in tree.items():
            site = site_by_name[sname]
            tr = {k: torch.randn(ad[k].shape, generator=g_, device=dev)
                  for k in names}
            if m_.linear_delta:
                dw = m_.site_delta({**ad, **tr}, site,
                                   prof.replace(kernel_backend="einsum"))
                w = bparams["base"]["layers"][sname.split("/")[-1]]
                scale = 0.5 * float(w.norm()) / float(dw.norm())
                del dw
            else:
                scale = 0.5 * 0.02 * math.sqrt(site.d_in)
            out[sname] = {k: (v * scale if mname != "lora" or k == "lora_b"
                              else v) for k, v in tr.items()}
        return out

    for i, (mname, prof) in enumerate(bank_profiles.items()):
        adapter_ckpt.export_adapter(str(tenant_dir), tenant_ids[i],
                                    moving_tenant(mname, prof, 100 + i), prof)
    return bank_profiles, tenant_ids


def bank_phase(dev, cfg, prompts, slots: int, max_len: int, ps: int,
               pps: int, gen, timing_layers) -> int:
    """Phase 13 (module docstring) on `dev`, over phase 7's model config
    `cfg`, prompts and cache geometry. Returns K3's launches in the bank
    trace; raises PhaseError when a check fails."""
    import shutil
    import torch
    from repro_torch.checkpoint import adapters as adapter_ckpt
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.core import adapter as adapter_api
    from repro_torch.core import peft as peft_mod
    from repro_torch.kernels import dct_deltaw as ddk
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.launch.serve import demo_trace
    from repro_torch.models import build
    from repro_torch.serve import (AdapterBank, ContinuousScheduler, Engine,
                                   Request)
    bcfg = cfg.replace(dtype="float32", param_dtype="float32")
    bmodel = build(bcfg, PEFTConfig(method="none"))
    bparams = bmodel.init(0, dev)
    site_by_name = {s_.name: s_ for s_ in bmodel.sites}
    tenant_dir = Path(__file__).resolve().parent / "build" / "smoke_tenants"
    bank_profiles, tenant_ids = bank_tenants(dev, bmodel, bparams, tenant_dir)
    print(f"[bank] yi-6b full width, {bcfg.num_layers} layers, float32 over "
          f"the clean base; tenants {tenant_ids} on wq/wv, bank capacity 3, "
          "the launcher's 12-request trace cycling the tenants and None")
    bank = AdapterBank(bmodel, bank_profiles, capacity=3,
                       checkpoint_dir=str(tenant_dir), device=dev)
    bengine = Engine(bmodel, bparams, batch_slots=slots, max_len=max_len,
                     bank=bank, device=dev)
    bare = Engine(bmodel, bparams, batch_slots=slots, max_len=max_len,
                  device=dev)
    circ = [r for r in bengine.kernel_policy.resolutions
            if r.bank == "circulant"]
    print(f"[bank] frozen tables built once: {bank.table_bytes} bytes "
          f"({bank.table_bytes / 2 ** 20:.1f} MiB: fourierft 4 and dct 2 "
          f"f32 (d, n) tables per site); circulant bank_apply -> "
          f"{circ[0].backend} (torch.fft, a library call)")
    cycle = tenant_ids + [None]
    breqs, barrivals = demo_trace(prompts, 12, 16, 2.0, cycle)
    loads0 = bank.loads
    pak.launches = fdk.launches = ddk.launches = 0
    bsched = ContinuousScheduler(bengine, page_size=ps)
    bsched.serve(breqs, barrivals)
    torch.cuda.synchronize()
    k3_bank, bank_loads = pak.launches, bank.loads - loads0
    bsteps = bsched.metrics.steps
    for i, r in enumerate(breqs):
        if r.out is None or len(r.out) != r.max_new:
            raise PhaseError(f"bank request {i} emitted {r.out!r}, budget "
                        f"{r.max_new}")
    if k3_bank != bsteps * bcfg.num_layers:
        raise PhaseError(f"bank serve: K3 launched {k3_bank} times, expected "
                    f"{bsteps} decode steps x {bcfg.num_layers}")
    if bank_loads < 6:
        raise PhaseError(f"bank serve: the bank loaded {bank_loads} times, "
                    "expected at least 6 (capacity 3, five tenants)")
    bs = bsched.metrics.summary()
    print(f"[bank] serve: {len(breqs)} requests, {bs['total_tokens']:.0f} "
          f"tokens in {bsteps} decode steps, {bs['tokens_per_s']:.1f} tok/s "
          f"| K3 launches {k3_bank} | bank loads {bank_loads} "
          f"({bank_loads - bank.capacity} evictions mid-trace), resident "
          f"at the end {list(bank.resident_ids)}")
    # a None request decodes bitwise what the bare base decodes
    nreqs, _ = demo_trace(prompts, 12, 16, 2.0)
    ContinuousScheduler(bare, page_size=ps).serve(nreqs, barrivals)
    for i, (r, rn) in enumerate(zip(breqs, nreqs)):
        if r.adapter_id is None and r.out != rn.out:
            raise PhaseError(f"bank serve: the None request {i} decoded "
                        f"{r.out}, the bare base {rn.out}")
    moved = sum(r.adapter_id is not None and r.out != rn.out
                for r, rn in zip(breqs, nreqs))
    resident = list(bank.resident_ids)
    ids = [resident[i % len(resident)] if i % 4 else None
           for i in range(slots)]
    toks = torch.zeros((slots, max(int(p.shape[0]) for p in prompts)),
                       dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :p.shape[0]] = p.to(dev)
    with torch.no_grad():
        bparams_b, bextra = bengine._batch_extra(ids)
        lb = bengine.model.forward(bparams_b, {"tokens": toks, **bextra})
        ln = bare.model.forward(bare.params, {"tokens": toks})
    none_rows = [i for i, a in enumerate(ids) if a is None]
    if not all(torch.equal(lb[i], ln[i]) for i in none_rows):
        raise PhaseError("bank: a None row's logits differ from the bare base's")
    print(f"[bank] None requests: tokens and logits bitwise the bare base's "
          f"(f32); {moved} of {sum(r.adapter_id is not None for r in breqs)}"
          " tenant requests decode other tokens than the base")
    # each request's first token against its serial Engine.generate
    for i, r in enumerate(breqs):
        if r.adapter_id is not None and \
                r.adapter_id not in bank.resident_ids:
            bank.load_from_checkpoint(r.adapter_id)
        first = bengine.generate([r.prompt], max_new=1,
                                 adapter_ids=[r.adapter_id])[0].tolist()
        if first[0] != r.out[0]:
            raise PhaseError(f"bank: request {i} ({r.adapter_id}) first token "
                        f"{r.out[0]}, serial Engine.generate {first[0]}")
    print("[bank] every request's first token equals its serial "
          "Engine.generate with the same bank (f32)")
    # the FourierFT tenant's bank apply against x @ K1's ΔW
    ftree, fprof = adapter_ckpt.import_adapter(str(tenant_dir),
                                               "t-fourierft", device=dev)
    fm = adapter_api.resolve("fourierft")
    bank_err = 0.0
    for sname in ("layers/wq", "layers/wv"):
        site = site_by_name[sname]
        aux = bank.params["fourierft"]["aux"][sname]
        c = ftree[sname]["c"]                            # (L, n) as B rows
        x = torch.randn((c.shape[0], 1, site.d_in), generator=gen,
                        device=dev)
        y = fm.bank_apply(x, {"c": c}, aux, site.d_in, site.d_out, fprof)
        ref = torch.matmul(x, kops.fourier_deltaw_forward(
            c, aux["entries"], site.d_in, site.d_out, fprof.alpha))
        scale = float(ref.abs().max())
        diff = (y - ref).abs()
        bank_err = max(bank_err, float(diff.max()))
        if bool((diff > 1e-6 * scale + 5e-4 * ref.abs()).any()):
            raise PhaseError(f"bank: FourierFT bank_apply at {sname} "
                        f"{site.d_in}x{site.d_out} differs from x @ K1's ΔW "
                        f"by {float(diff.max()):.3e} (max |y| {scale:.3e})")
        print(f"[bank] FourierFT bank_apply at {sname} {site.d_in}x"
              f"{site.d_out}: max |apply - x @ K1 ΔW| "
              f"{float(diff.max()):.3e}, max |y| {scale:.3e} (atol 1e-6 x "
              "max |y|, rtol 5e-4)")
    # generate_requests stops after the EOS step
    eos_case = None
    for p in prompts:
        for tid in cycle:
            if tid is not None and tid not in bank.resident_ids:
                bank.load_from_checkpoint(tid)
            probe = [Request(prompt=p, max_new=10, adapter_id=tid)]
            bengine.generate_requests(probe)
            k = next((k for k in range(2, 10)
                      if probe[0].out[k] not in probe[0].out[:k]), None)
            if k is not None:
                eos_case = (p, tid, probe[0].out, k)
                break
        if eos_case is not None:
            break
    if eos_case is None:
        raise PhaseError("bank: no stream shows a new token to stop on")
    p, tid, probe_out, k = eos_case
    calls = [0]
    real_decode = bengine.model.decode_step

    def counting_decode(*a, **kw):
        calls[0] += 1
        return real_decode(*a, **kw)

    bengine.model.decode_step = counting_decode
    reqs_eos = [Request(prompt=p, max_new=10, adapter_id=tid)]
    bengine.generate_requests(reqs_eos, eos_id=probe_out[k])
    del bengine.model.decode_step
    if reqs_eos[0].out != probe_out[:k + 1] or calls[0] != k:
        raise PhaseError(f"bank: generate_requests with EOS at step {k} gave "
                    f"{reqs_eos[0].out} in {calls[0]} decode calls, "
                    f"expected {probe_out[:k + 1]} in {k}")
    print(f"[bank] generate_requests ({tid}): EOS first emitted at step {k} "
          f"-> {k} decode calls, not 9")
    del bengine, bare, bsched, bank, bparams, lb, ln
    shutil.rmtree(tenant_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # decode-step time: the bank engine (five groups, all resident, 8 slots
    # gathering all five and the zero row) against the merged one-adapter
    # engine, bf16, same shapes, in turns; and the bank step's busy share
    def step_times(layers: int, steps: int = 12):
        tcfg_ = cfg.replace(num_layers=layers)
        fpeft = PEFTConfig(method="fourierft", n=1000, alpha=300.0)
        m_ = build(tcfg_, fpeft)
        p_ = m_.init(0, dev)
        merged = Engine(m_, p_, batch_slots=slots, max_len=max_len,
                        device=dev)
        base_model = build(tcfg_, PEFTConfig(method="none"))
        tbank = AdapterBank(base_model, bank_profiles, capacity=slots,
                            device=dev)
        g_ = torch.Generator(device=dev)
        g_.manual_seed(3)
        for tid, (mname, prof) in zip(tenant_ids, bank_profiles.items()):
            tree = peft_mod.init_adapters(g_, base_model.sites, prof, dev)
            names = adapter_api.resolve(mname).trainable_leaves(prof)
            tbank.load(tid, {s_: {k_: torch.randn(v_.shape, generator=g_,
                                                  device=dev)
                                  for k_, v_ in ad.items() if k_ in names}
                             for s_, ad in tree.items()}, prof)
        banked = Engine(base_model, {"base": p_["base"], "peft": {}},
                        batch_slots=slots, max_len=max_len, bank=tbank,
                        device=dev)
        ids_ = (tenant_ids + [None] + tenant_ids)[:slots]
        runs = {}
        for label, eng in (("merged", merged), ("bank", banked)):
            cache = eng._fresh_cache(paged=True, page_size=ps,
                                     n_pages=slots * pps + slots)
            bt = (torch.arange(slots * pps, dtype=torch.int32, device=dev)
                  .reshape(slots, pps) + slots)
            prm, extra = eng._batch_extra(ids_ if eng is banked else None)
            batch = {"tokens": torch.randint(
                0, tcfg_.vocab, (slots, 1), generator=g_, device=dev,
                dtype=torch.int32), "block_table": bt,
                "scratch_pages": torch.arange(slots, dtype=torch.int32,
                                              device=dev), **extra}

            @torch.no_grad()
            def one(eng=eng, cache=cache, prm=prm, batch=batch):
                cache["pos"].fill_(100)
                eng.model.decode_step(prm, cache, batch)
            runs[label] = one
        walls = {"merged": [], "bank": []}
        for label in ("merged", "bank", "bank", "merged"):
            fn = runs[label]
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            for _ in range(steps // 2):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[label].append(time.perf_counter() - t0)
        med = {k_: sorted(v_)[len(v_) // 2] * 1e3 for k_, v_ in walls.items()}
        res = {"layers": layers, "steps_each": len(walls["bank"]),
               "table_bytes": tbank.table_bytes}
        for k_ in ("merged", "bank"):
            d_ms, kernels, top = device_ms(runs[k_], 10)
            res[f"{k_}_ms"] = med[k_]
            res[f"{k_}_device_ms"] = d_ms
            res[f"{k_}_busy_share"] = d_ms / med[k_] if d_ms else None
            res[f"{k_}_kernels_per_step"] = kernels
            res[f"{k_}_top_kernels_ms"] = top
        del merged, banked, tbank, p_, runs
        torch.cuda.empty_cache()
        return res

    bank_timing = []
    for layers in timing_layers:
        r_ = step_times(layers)
        bank_timing.append(r_)
        busy = {k_: (f"device {r_[k_ + '_device_ms']:.3f} ms/step in "
                     f"{r_[k_ + '_kernels_per_step']:.0f} kernels, busy "
                     f"{r_[k_ + '_busy_share']:.1%}"
                     if r_[k_ + "_device_ms"] else "device not measured")
                for k_ in ("merged", "bank")}
        print(f"[bank] decode step, {layers} layers, bf16, 8 slots at kv_len "
              f"101 (median of {r_['steps_each']} each, in turns): merged "
              f"one-adapter engine {r_['merged_ms']:.3f} ms ({busy['merged']})"
              f", bank engine (5 groups) {r_['bank_ms']:.3f} ms "
              f"({busy['bank']}); cached tables {r_['table_bytes']} bytes")
        for k_ in ("merged", "bank"):
            for kname, kms in r_[k_ + "_top_kernels_ms"]:
                print(f"[bank]   {layers} layers, {k_} step: {kms:.4f} "
                      f"ms/step  {kname}")
    print(json.dumps({"bank": {"k3_launches": k3_bank, "steps": bsteps,
                               "loads": bank_loads,
                               "bank_apply_max_abs_err": bank_err,
                               "decode_step": bank_timing}}))
    return k3_bank


def spec_phase(dev, cfg, prompts, slots: int, max_len: int, ps: int,
               pps: int, timing_layers) -> dict:
    """Phase 14 (module docstring) on `dev`, over phase 7's model config
    `cfg`, prompts and cache geometry. Returns K3's launches by path and
    by W in the checked runs, and its largest |K3 - plain| at the path's
    window shapes; raises PhaseError when a check fails."""
    import shutil
    import statistics
    import torch
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.launch.serve import demo_trace
    from repro_torch.models import build, transformer
    from repro_torch.serve import (AdapterBank, ContinuousScheduler, Engine,
                                   NGramDrafter, SelfDrafter)
    L = cfg.num_layers
    fpeft = PEFTConfig(method="fourierft", n=1000, alpha=300.0)

    def serve(engine, reqs, arrivals, **kw):
        """(scheduler, streams, K3 launches by W) of one trace replay."""
        pak.launches, pak.launches_by_w = 0, {}
        sched = ContinuousScheduler(engine, page_size=ps, **kw)
        sched.serve(reqs, arrivals)
        torch.cuda.synchronize()
        if sched._pending:
            raise PhaseError("spec: buffered decode entries left behind")
        return sched, [r.out for r in reqs], dict(pak.launches_by_w)

    def trace(tenants=()):
        return demo_trace(prompts, 12 if tenants else 8, 16, 2.0, tenants)

    def want(what, got, expected):
        if got != expected:
            raise PhaseError(f"spec {what}: K3 launches by W {got}, "
                             f"expected {expected}")

    k3_held = {}            # "dtype layers W W" -> K3 against plain

    def hold_k3_windows(eng, label: str, gate_logits: bool = True):
        """verify_logits on the serving cache geometry (8 slots, page 16,
        8 pages a slot, the pools seeded) at W 4 (bank k = 3) and W 5
        (k = 4), positions ragged to 125 (the last window runs past the
        block table), twice: through K3, each layer's K3 output held
        against the plain version on the same inputs within
        pak.agreement_limit, and through the plain version; the logits
        held at the tolerance of test_verify_step_through_k3_matches_plain
        (f32 atol = rtol = 1e-4 and the same tokens; bf16 5e-2 of each
        row's largest |logit|) where `gate_logits`, else reported: over 32
        bf16 layers of a random-weight model the two forwards' rounding
        compounds past that, while every layer's K3 output is held."""
        m_ = eng.model
        cache = eng._fresh_cache(paged=True, page_size=ps,
                                 n_pages=slots * pps + slots)
        dtype = cache["pk"].dtype
        g_ = torch.Generator(device=dev)
        g_.manual_seed(11)
        for key in ("pk", "pv"):
            cache[key].copy_(torch.randn(cache[key].shape, generator=g_,
                                         device=dev).to(dtype))
        extra = {"block_table": (torch.arange(slots * pps, dtype=torch.int32,
                                              device=dev)
                                 .reshape(slots, pps) + slots),
                 "scratch_pages": torch.arange(slots, dtype=torch.int32,
                                               device=dev)}
        pos = torch.tensor([0, 1, 17, 40, 64, 99, 101, 125][:slots],
                           dtype=torch.int32, device=dev)
        k3 = m_.paged_attention(dev, dtype)
        for W in (4, 5):
            worst = {"err": 0.0, "of_limit": 0.0, "calls": 0}

            def held(q, kp, vp, bt, kv_len):
                out = k3(q, kp, vp, bt, kv_len)
                ref = pak.paged_attention_reference(q.float(), kp.float(),
                                                    vp.float(), bt, kv_len)
                diff = (out.float() - ref).abs()
                if not torch.isfinite(out.float()).all():
                    raise PhaseError(f"spec K3 {label} W {W}: non-finite "
                                     "output")
                worst["err"] = max(worst["err"], float(diff.max()))
                worst["of_limit"] = max(worst["of_limit"], float(
                    (diff / pak.agreement_limit(ref, dtype)).max()))
                worst["calls"] += 1
                return out

            toks = torch.randint(0, m_.cfg.vocab, (slots, W), generator=g_,
                                 device=dev, dtype=torch.int32)
            logits = {}
            with torch.no_grad():
                for name, fn in (("k3", held),
                                 ("plain", pak.paged_attention_reference)):
                    c_ = {key: cache[key].clone() for key in ("pk", "pv")}
                    c_["pos"] = pos.clone()
                    logits[name] = transformer.verify_logits(
                        eng.params["base"], eng.params["peft"], c_,
                        {"tokens": toks, **extra}, m_.cfg, m_.peft, m_.sites,
                        paged_attention=fn)[0].float()
                    del c_
            lk, lp = logits["k3"], logits["plain"]
            if dtype == torch.float32:
                ok = (torch.allclose(lk, lp, atol=1e-4, rtol=1e-4)
                      and torch.equal(lk.argmax(-1), lp.argmax(-1)))
            else:
                ok = bool(((lk - lp).abs()
                           <= 5e-2 * lp.abs().amax(-1, keepdim=True)).all())
            logit_err = float((lk - lp).abs().max())
            if (worst["calls"] != m_.cfg.num_layers
                    or not worst["of_limit"] <= 1.0
                    or (gate_logits and not ok)):
                raise PhaseError(
                    f"spec K3 {label} W {W}: {worst['calls']} K3 calls, "
                    f"K3 against its plain version {worst['err']:.3e} "
                    f"({worst['of_limit']:.3f} of the limit), logits "
                    f"max |diff| {logit_err:.3e} (within tolerance: {ok})")
            k3_held[f"{label} W {W}"] = {**worst, "logits_err": logit_err,
                                         "logits_within": ok}
            print(f"[spec] K3 at W {W}, {label}, 8 slots, positions "
                  f"{pos.tolist()}: max |K3 - plain| {worst['err']:.3e} "
                  f"({worst['of_limit']:.3f} of the limit) over "
                  f"{worst['calls']} layers; logits max |diff| "
                  f"{logit_err:.3e} against the plain forward (within the "
                  f"test's tolerance: {ok}, "
                  f"{'required' if gate_logits else 'reported'})")
        del cache

    # ---- f32 checks on phase 7's merged FourierFT model --------------------
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    model = build(cfg32, fpeft)
    params = model.init(0, dev)
    fdk.launches = 0
    engine = Engine(model, params, batch_slots=slots, max_len=max_len,
                    device=dev)
    if fdk.launches != 2:
        raise PhaseError(f"spec: the merge launched K1 {fdk.launches} times, "
                         "expected one per site (2)")
    del params
    print(f"[spec] yi-6b full width, {L} layers, float32 (TF32 off), "
          f"FourierFT merged by K1; {slots} slots, page {ps}, the "
          "launcher's 8-request trace")
    hold_k3_windows(engine, f"float32 {L} layers")
    plain, base, by_w = serve(engine, *trace())
    want("plain", by_w, {1: plain.metrics.steps * L})
    runs = {}
    for label, drafter, kw in (
            ("self k=4", SelfDrafter(k=4), {}),
            ("ngram k=4", NGramDrafter(k=4), {}),
            ("dense self k=3", SelfDrafter(k=3), {"paged": False})):
        sched, outs, by_w = serve(engine, *trace(), drafter=drafter, **kw)
        if outs != base:
            raise PhaseError(f"spec {label}: streams differ from the plain "
                             f"scheduler's: {outs} against {base}")
        steps, k = sched.metrics.steps, drafter.k
        expected = {}
        if kw.get("paged", True):
            expected[k + 1] = L * steps
            if isinstance(drafter, SelfDrafter):
                expected[1] = L * steps * k
        want(label, by_w, expected)
        sm = sched.metrics.summary()
        runs[label] = {"verify_steps": steps, "launches_by_w": by_w,
                       "tokens_per_step": sm["spec_tokens_per_step"],
                       "accept_rate": sm["spec_accept_rate"]}
        print(f"[spec] {label}: streams equal the plain scheduler's | "
              f"{steps} verify steps against {plain.metrics.steps} decode "
              f"steps, {sm['spec_tokens_per_step']:.2f} tokens per "
              f"slot-step, accept rate {sm['spec_accept_rate']:.2f} | K3 "
              f"launches by W {by_w}")
    if not runs["self k=4"]["tokens_per_step"] > 1.0:
        raise PhaseError("spec: the self-drafter emitted no more than one "
                         "token per slot-step")
    # EOS inside the window: the EOS id is a token the plain run emitted
    # early in its longest stream, so at least one request stops short
    longest = max(base, key=len)
    eos = longest[2]
    _, e_base, _ = serve(engine, *trace(), eos_id=eos)
    _, e_spec, _ = serve(engine, *trace(), eos_id=eos,
                         drafter=SelfDrafter(k=3))
    reqs0, _ = trace()
    cut = sum(len(o) < r.max_new for o, r in zip(e_spec, reqs0))
    if e_spec != e_base or not cut:
        raise PhaseError(f"spec EOS {eos}: streams {e_spec}, plain {e_base}, "
                         f"{cut} requests cut short")
    print(f"[spec] EOS {eos} inside the window (self k=3): streams equal "
          f"the plain scheduler's, {cut} requests cut short")
    del engine, plain

    # ---- the bank's tenants and None with the self-drafter, f32 ------------
    bmodel = build(cfg32, PEFTConfig(method="none"))
    bparams = bmodel.init(0, dev)
    tenant_dir = Path(__file__).resolve().parent / "build" / "smoke_tenants"
    profiles, tenant_ids = bank_tenants(dev, bmodel, bparams, tenant_dir)
    bank = AdapterBank(bmodel, profiles, capacity=3,
                       checkpoint_dir=str(tenant_dir), device=dev)
    bengine = Engine(bmodel, bparams, batch_slots=slots, max_len=max_len,
                     bank=bank, device=dev)
    bare = Engine(bmodel, bparams, batch_slots=slots, max_len=max_len,
                  device=dev)
    cycle = tenant_ids + [None]
    _, b_base, _ = serve(bengine, *trace(cycle))
    bsched, b_spec, b_w = serve(bengine, *trace(cycle),
                                drafter=SelfDrafter(k=3))
    if b_spec != b_base:
        raise PhaseError(f"spec bank: streams {b_spec} differ from the plain "
                         f"bank scheduler's {b_base}")
    bsteps = bsched.metrics.steps
    want("bank", b_w, {1: L * bsteps * 3, 4: L * bsteps})
    _, n_bare, _ = serve(bare, *demo_trace(prompts, 12, 16, 2.0))
    breqs, _ = trace(cycle)
    for i, r in enumerate(breqs):
        if r.adapter_id is None and b_spec[i] != n_bare[i]:
            raise PhaseError(f"spec bank: the None request {i} decoded "
                             f"{b_spec[i]}, the bare base {n_bare[i]}")
    bsm = bsched.metrics.summary()
    print(f"[spec] bank (5 tenants and None, capacity 3, self k=3): streams "
          f"equal the plain bank scheduler's, None requests the bare "
          f"base's | {bsteps} verify steps, "
          f"{bsm['spec_tokens_per_step']:.2f} tokens per slot-step, accept "
          f"rate {bsm['spec_accept_rate']:.2f} | K3 launches by W {b_w}")
    runs["bank self k=3"] = {"verify_steps": bsteps, "launches_by_w": b_w,
                             "tokens_per_step": bsm["spec_tokens_per_step"],
                             "accept_rate": bsm["spec_accept_rate"]}
    del bengine, bare, bank, bparams
    shutil.rmtree(tenant_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- bf16 timing: the trace's tokens/s, decode and verify steps -------
    def timing(layers: int, steps: int = 12):
        tcfg = cfg.replace(num_layers=layers)
        m_ = build(tcfg, fpeft)
        eng = Engine(m_, m_.init(0, dev), batch_slots=slots,
                     max_len=max_len, device=dev)
        drafters = {"plain": lambda: None, "self": lambda: SelfDrafter(k=4),
                    "ngram": lambda: NGramDrafter(k=4)}
        hold_k3_windows(eng, f"bfloat16 {layers} layers",
                        gate_logits=layers <= SLICE_LAYERS)
        serve(eng, *trace())                              # warm-up
        tps = {k_: [] for k_ in drafters}
        outs, spec = {}, {}
        for label in ("plain", "self", "ngram", "ngram", "self", "plain"):
            sched, o, _ = serve(eng, *trace(), drafter=drafters[label]())
            sm = sched.metrics.summary()
            tps[label].append(sm["tokens_per_s"])
            outs[label] = o
            if label != "plain":
                spec[label] = (sm["spec_tokens_per_step"],
                               sm["spec_accept_rate"])
        same = {}
        for label in ("self", "ngram"):
            pairs = [(a, b) for x, y in zip(outs[label], outs["plain"])
                     for a, b in zip(x, y)]
            same[label] = sum(a == b for a, b in pairs) / len(pairs)
        # one step alone, 8 slots at kv_len 101, in turns: decode (W 1),
        # verify (W 5), and the self-drafter's step (4 probes + verify)
        cache = eng._fresh_cache(paged=True, page_size=ps,
                                 n_pages=slots * pps + slots)
        bt = (torch.arange(slots * pps, dtype=torch.int32, device=dev)
              .reshape(slots, pps) + slots)
        cache["pos"].fill_(100)
        g_ = torch.Generator(device=dev)
        g_.manual_seed(5)
        win = torch.randint(0, tcfg.vocab, (slots, 5), generator=g_,
                            device=dev, dtype=torch.int32)
        extra = {"block_table": bt,
                 "scratch_pages": torch.arange(slots, dtype=torch.int32,
                                               device=dev)}

        @torch.no_grad()
        def decode():
            eng.model.decode_step(eng.params, cache,
                                  {"tokens": win[:, :1], **extra})

        @torch.no_grad()
        def verify():
            eng.model.verify_step(eng.params, cache,
                                  {"tokens": win, **extra})

        @torch.no_grad()
        def self_step():
            c, t = cache, win[:, :1]
            for _ in range(4):
                nt, c = eng.model.decode_step(eng.params, c,
                                              {"tokens": t, **extra})
                t = nt[:, None]
            eng.model.verify_step(eng.params, cache, {"tokens": win, **extra})

        fns = {"decode": decode, "verify": verify, "self_step": self_step}
        walls = {k_: [] for k_ in fns}
        for label in ("decode", "verify", "self_step", "self_step", "verify",
                      "decode"):
            for _ in range(2):
                fns[label]()
            torch.cuda.synchronize()
            for _ in range(steps // 2):
                t0 = time.perf_counter()
                fns[label]()
                torch.cuda.synchronize()
                walls[label].append(time.perf_counter() - t0)
        res = {"layers": layers,
               "tokens_per_s": tps,
               "tokens_per_step": {k_: v[0] for k_, v in spec.items()},
               "accept_rate": {k_: v[1] for k_, v in spec.items()},
               "bf16_tokens_equal_plain": same}
        for k_, fn in fns.items():
            med = statistics.median(walls[k_]) * 1e3
            d_ms, kernels, _ = device_ms(fn, 5)
            res[f"{k_}_ms"] = med
            res[f"{k_}_device_ms"] = d_ms
            res[f"{k_}_busy_share"] = d_ms / med if d_ms else None
            res[f"{k_}_kernels"] = kernels
        del eng, cache, m_
        torch.cuda.empty_cache()
        return res

    spec_timing = []
    for layers in timing_layers:
        r_ = timing(layers)
        spec_timing.append(r_)
        tps = {k_: statistics.mean(v) for k_, v in r_["tokens_per_s"].items()}
        print(f"[spec] bf16, {layers} layers, 8 slots, the launcher's trace: "
              f"tokens/s plain {tps['plain']:.1f}, self k=4 "
              f"{tps['self']:.1f}, ngram k=4 {tps['ngram']:.1f} (means of "
              f"two runs each, in turns: {r_['tokens_per_s']}) | tokens per "
              f"slot-step {r_['tokens_per_step']}, accept rate "
              f"{r_['accept_rate']} | bf16 tokens equal to the plain run's: "
              f"{r_['bf16_tokens_equal_plain']}")
        busy = {k_: (f"device {r_[k_ + '_device_ms']:.3f} ms in "
                     f"{r_[k_ + '_kernels']:.0f} kernels, busy "
                     f"{r_[k_ + '_busy_share']:.1%}"
                     if r_[k_ + "_device_ms"] else "device not measured")
                for k_ in ("decode", "verify", "self_step")}
        print(f"[spec] bf16, {layers} layers, one step alone at kv_len 101 "
              f"(median of 12 each, in turns): "
              f"decode {r_['decode_ms']:.3f} ms ({busy['decode']}), verify "
              f"W 5 {r_['verify_ms']:.3f} ms ({busy['verify']}), self-drafter "
              f"step (4 probes + verify) {r_['self_step_ms']:.3f} ms "
              f"({busy['self_step']})")
    print(json.dumps({"spec": {"runs": runs, "timing": spec_timing,
                               "k3_windows": k3_held}}))
    return {"spec_serve": sum(runs["self k=4"]["launches_by_w"].values()),
            "spec_bank_serve": sum(b_w.values()),
            "w_gt_1": sum(n for r in runs.values()
                          for w, n in r["launches_by_w"].items() if w > 1)
            }, max(v["err"] for v in k3_held.values())


def paper_phase(dev, cfgs, prompts, slots: int, max_len: int, ps: int,
                pps: int, long_pps: int = 256) -> dict:
    """Phase 16 (module docstring) on `dev`. `cfgs` maps each part to its
    model config: "llama" (a), "roberta" (b), "gpt2" (c) and "factored"
    (d, phase 7's). Returns the launch counts of each part's run by
    kernel; raises PhaseError when a check fails."""
    import torch
    from repro_torch.configs.base import PEFTConfig, TrainConfig
    from repro_torch.core import basis as basis_mod
    from repro_torch.core import peft as peft_mod
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.launch.serve import demo_trace
    from repro_torch.models import build
    from repro_torch.serve import ContinuousScheduler, Engine
    from repro_torch.serve import merge_for_serving
    from repro_torch.train import step as train_step
    from repro_torch.tree import tree_leaves, tree_unflatten
    fpeft = PEFTConfig(method="fourierft", n=1000, alpha=300.0)
    B, S, mb = 8, 64, MICROBATCH
    out = {}
    t_phase = time.perf_counter()
    # device memory still held by the earlier phases (the figures below
    # count from it)
    earlier = torch.cuda.memory_allocated() / 2 ** 30
    sync = torch.cuda.synchronize

    # ---- a. LLaMA2-7B at full size: accounting, train, merge, serve --------
    cfg = cfgs["llama"]
    model = build(cfg, fpeft)
    qv = peft_mod.qv_sites_for(cfg)
    L = cfg.num_layers
    count = peft_mod.count_trainable(qv, fpeft)
    store = peft_mod.storage_bytes(qv, fpeft)
    lora = peft_mod.count_trainable(qv, PEFTConfig(method="lora", lora_r=64))
    shapes = len({(s_.d_in, s_.d_out) for s_ in qv})
    want = (fpeft.n * 2 * L, (fpeft.n * 2 * L + 2 * fpeft.n * shapes) * 4,
            64 * 2 * (cfg.d_model + cfg.attn_dim) * L)
    if cfg.name == "llama2-7b":
        want = (64_000, 264_000, 33_554_432)       # paper Table 1
    if (count, store, lora) != want or model.trainable_params() != count:
        raise PhaseError(f"paper {cfg.name}: Table 1 accounting "
                         f"{(count, store, lora)}, expected {want}")
    print(f"[paper] {cfg.name}: {L} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv} of {cfg.head_dim} (G = "
          f"{cfg.n_heads // cfg.n_kv}), d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; Table 1: FourierFT n {fpeft.n} on q/v "
          f"{count:,} trainables, {store:,} storage bytes "
          f"({store / 1024:.1f} KiB); LoRA r 64 {lora:,} trainables "
          f"({count / lora:.4%} of it)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_base = sum(t.numel() for t in tree_leaves(params["base"]))
    held = torch.cuda.memory_allocated() / 2 ** 30
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(learning_rate=1e-2, total_steps=4, warmup_steps=1,
                       microbatch=mb)
    bs = synthetic_batches(dev, cfg, B, S, 4)
    zero_counts()
    state, frozen, losses, secs = checked_steps(
        model, tcfg, params, bs, f"paper {cfg.name}", sync)
    got = launch_counts()
    expected = len(bs) * mb * 2
    if got["K1"] != expected or got["K2"] != expected:
        raise PhaseError(f"paper {cfg.name} train: K1 launched {got['K1']}, "
                         f"K2 {got['K2']} times; expected {len(bs)} steps x "
                         f"{mb} microbatches x 2 sites = {expected} each")
    if not c_moved(state, params):
        raise PhaseError(f"paper {cfg.name} train: the coefficients never "
                         "moved")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    warm_ms = 1e3 * sum(secs[1:]) / len(secs[1:])
    out["llama_train"] = got
    print(f"[paper] {cfg.name} train: {n_base:,} base parameters made in "
          f"{init_s:.1f} s ({held:.2f} GiB held, {earlier:.2f} of it by the "
          f"earlier phases; peak {init_peak:.2f} GiB while made); {len(bs)} "
          f"steps of batch {B} x seq {S}, "
          f"microbatch {mb}: losses {[round(x, 4) for x in losses]} | K1 "
          f"{got['K1']}, K2 {got['K2']} launches | cold step "
          f"{secs[0] * 1e3:.1f} ms, warm {warm_ms:.1f} ms/step "
          f"({B * S / warm_ms * 1e3:.0f} tokens/s) | peak device memory "
          f"in the steps {peak:.2f} GiB")
    # where the step's memory goes: one microbatch's forward (the merged
    # weights, ΔW stacks and the activations autograd keeps) and backward,
    # after the counted steps (its launches are not counted)
    tr_ = train_step.split_params(model, params)[0]
    mem = {"before_gib": torch.cuda.memory_allocated() / 2 ** 30}
    torch.cuda.reset_peak_memory_stats()
    live = [t.detach().requires_grad_(True) for t in tree_leaves(tr_)]
    with torch.enable_grad():
        loss_ = train_step._loss_for(model)(
            tree_unflatten(tr_, live), frozen,
            {k: t[:B // mb] for k, t in bs[0].items()})
        torch.cuda.synchronize()
        mem["forward_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        mem["kept_for_backward_gib"] = (torch.cuda.memory_allocated()
                                        / 2 ** 30 - mem["before_gib"])
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.grad(loss_, live)
    torch.cuda.synchronize()
    mem["backward_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del loss_, live, tr_
    print(f"[paper] {cfg.name} one microbatch (4 x {S}): "
          f"{mem['before_gib']:.2f} GiB held before it, forward peak "
          f"{mem['forward_peak_gib']:.2f} GiB, "
          f"{mem['kept_for_backward_gib']:.2f} GiB kept for the backward, "
          f"backward peak {mem['backward_peak_gib']:.2f} GiB")
    # free the train state; the trained coefficients join the frozen tree
    params = model.join(state["trainable"], frozen)
    del state, frozen
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    engine = Engine(model, params, batch_slots=slots, max_len=max_len,
                    device=dev)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    k1_merge = fdk.launches
    sched = ContinuousScheduler(engine, page_size=ps)
    reqs, arrivals = demo_trace(prompts, 8, 16, 2.0)
    pak.launches = 0
    sched.serve(reqs, arrivals)
    torch.cuda.synchronize()
    k3 = pak.launches
    steps = sched.metrics.steps
    out["llama_serve"] = {"K1": k1_merge, "K3": k3}
    for i, r in enumerate(reqs):
        if r.out is None or len(r.out) != r.max_new:
            raise PhaseError(f"paper {cfg.name} serve: request {i} emitted "
                             f"{r.out!r}, budget {r.max_new}")
    if k1_merge != 2 or k3 != steps * L:
        raise PhaseError(f"paper {cfg.name} serve: K1 launched {k1_merge} "
                         f"times (expected 2), K3 {k3} (expected {steps} "
                         f"decode steps x {L})")
    s_ = sched.metrics.summary()
    print(f"[paper] {cfg.name} serve: merge {merge_s:.3f} s (K1 "
          f"{k1_merge}), {len(reqs)} requests, {s_['total_tokens']:.0f} "
          f"tokens in {steps} decode steps, {s_['tokens_per_s']:.1f} tok/s, "
          f"ttft {s_['ttft_steps_mean']:.2f} steps | K3 launches {k3}")
    _, plain = merge_for_serving(
        build(cfg, fpeft.replace(kernel_backend="einsum")), params)
    for key in ("wq", "wv"):
        ok, ndiff = merged_within_one_ulp(
            params["base"]["layers"][key],
            engine.params["base"]["layers"][key],
            plain["base"]["layers"][key])
        if not ok:
            raise PhaseError(f"paper {cfg.name} merged {key}: K1 and plain "
                             "merges differ by more than one bf16 ulp")
        print(f"[paper] {cfg.name} merged {key}: {ndiff} of "
              f"{params['base']['layers'][key].numel()} bf16 values differ "
              "from the einsum merge (each within one ulp)")
    del plain, sched
    torch.cuda.empty_cache()

    # the decode step alone (8 slots, bf16) at kv_len 101 and at 4096:
    # wall (median of 10), device time and K3's share of it at G = 1
    decode = {}
    for spps, pos in ((pps, 100), (long_pps, long_pps * ps - 1)):
        label = f"kv{pos + 1}"
        cache = engine._fresh_cache(paged=True, page_size=ps,
                                    n_pages=slots * spps + slots)
        for key in ("pk", "pv"):
            cache[key].normal_()
        batch = {"tokens": torch.arange(slots, dtype=torch.int32,
                                        device=dev)[:, None],
                 "block_table": (torch.arange(slots * spps, dtype=torch.int32,
                                              device=dev)
                                 .reshape(slots, spps) + slots),
                 "scratch_pages": torch.arange(slots, dtype=torch.int32,
                                               device=dev)}

        @torch.no_grad()
        def one(cache=cache, batch=batch, pos=pos):
            cache["pos"].fill_(pos)
            engine.model.decode_step(engine.params, cache, batch)
        for _ in range(3):
            one()
        torch.cuda.synchronize()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[len(walls) // 2] * 1e3
        d_ms, kernels, top = device_ms(one, 5)
        k3_ms = k3_device_ms(one, 5)
        decode[label] = {"kv_len": pos + 1, "wall_ms": wall,
                         "device_ms": d_ms, "kernels_per_step": kernels,
                         "k3_device_ms": k3_ms,
                         "k3_share": k3_ms / d_ms if d_ms and k3_ms
                         else None,
                         "busy_share": d_ms / wall if d_ms else None,
                         "top_kernels_ms": top}
        dtxt = (f"device {d_ms:.3f} ms in {kernels:.0f} kernels, busy "
                f"{d_ms / wall:.1%}, K3 {k3_ms:.3f} ms "
                f"({k3_ms / d_ms:.1%} of the device time)"
                if d_ms and k3_ms else "device not measured")
        print(f"[paper] {cfg.name} decode step, {L} layers, 8 slots at "
              f"kv_len {pos + 1}: {wall:.3f} ms wall ({dtxt})")
        del one, cache, batch
        torch.cuda.empty_cache()
    llama = {"train_losses": losses, "cold_ms": secs[0] * 1e3,
             "warm_ms": warm_ms, "tokens_per_s": B * S / warm_ms * 1e3,
             "earlier_phases_gib": earlier, "held_gib": held,
             "init_peak_gib": init_peak,
             "peak_gib": peak, "microbatch_memory": mem, "merge_s": merge_s, "decode_steps": steps,
             "serve_tokens_per_s": s_["tokens_per_s"], "decode": decode}
    del engine, params, model
    torch.cuda.empty_cache()

    # ---- b. Table-6 bases at roberta-base geometry, f32 ---------------------
    rcfg = cfgs["roberta"].replace(dtype="float32", param_dtype="float32")
    bases = {}
    for kind, n in (("random", 1000),
                    ("orthogonal", min(rcfg.d_model, rcfg.attn_dim))):
        bpeft = PEFTConfig(method="fourierft", n=n, alpha=300.0, basis=kind)
        bmodel = build(rcfg, bpeft)
        policy = bmodel.kernel_policy(dev)
        routes = {r.site: r for r in policy.resolutions if r.op == "deltaw"}
        if any(r.backend != "cuda" or "torch.matmul" not in r.note
               for r in routes.values()):
            raise PhaseError(f"paper {kind} basis: ΔW resolved to "
                             f"{[(r.backend, r.note) for r in routes.values()]}"
                             ", not the torch.matmul route")
        bparams = bmodel.init(0, dev)
        zero_counts()
        err = 0.0
        for site in bmodel.sites:
            ad = bparams["peft"].get(site.name)
            if ad is None:
                continue
            dw = bmodel.method.site_delta(ad, site, bpeft)
            # the same product in float64 on the same tensors (the einsum
            # op runs the same function as the route, so it is no check)
            ref = basis_mod.materialize_delta_basis(
                ad["c"].double(), ad["b1"].double(), ad["b2"].double(),
                kind, bpeft.alpha)
            diff = (dw.double() - ref).abs()
            err = max(err, float(diff.max()))
            if bool((diff > 2e-5 + 1e-4 * ref.abs()).any()):
                raise PhaseError(
                    f"paper {kind} {site.name}: the matmul route's ΔW "
                    f"differs from the float64 product by "
                    f"{float(diff.max()):.3e} (atol 2e-5, rtol 1e-4)")
        merged_model, merged = merge_for_serving(bmodel, bparams)
        mk = launch_counts()
        if mk["K1"] or mk["K2"] or merged_model.peft.method != "none":
            raise PhaseError(f"paper {kind}: merge launched {mk} or left "
                             f"method {merged_model.peft.method}")
        del merged
        tcfg = TrainConfig(learning_rate=1e-2, total_steps=3,
                           warmup_steps=1)
        zero_counts()
        state, _, losses_b, secs_b = checked_steps(
            bmodel, tcfg, bparams, synthetic_batches(dev, rcfg, B, S, 3),
            f"paper {rcfg.name}", sync)
        got = launch_counts()
        if got["K1"] or got["K2"]:
            raise PhaseError(f"paper {kind} train: launched {got}, expected "
                             "no K1 or K2")
        if not c_moved(state, bparams):
            raise PhaseError(f"paper {kind} train: the coefficients never "
                             "moved")
        bases[kind] = {"n": n, "max_abs_err": err, "losses": losses_b,
                       "warm_ms": 1e3 * sum(secs_b[1:]) / len(secs_b[1:]),
                       "launches": got}
        print(f"[paper] {rcfg.name} {kind} basis n {n} (f32): ΔW through "
              f"{next(iter(routes.values())).note!r} within {err:.3e} of "
              f"the float64 product (atol 2e-5, rtol 1e-4); 3 steps, "
              f"losses "
              f"{[round(x, 4) for x in losses_b]}, c moved, no K1/K2 launch")
        del state, bparams, bmodel
        torch.cuda.empty_cache()
    out["bases"] = bases

    # ---- c. `full` on gpt2-medium -------------------------------------------
    gcfg = cfgs["gpt2"]
    gmodel = build(gcfg, PEFTConfig(method="full"))
    gparams = gmodel.init(0, dev)
    before = [t.clone() for t in tree_leaves(gparams["base"])]
    tcfg = TrainConfig(learning_rate=1e-2, total_steps=3, warmup_steps=1)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state, _, losses_g, secs_g = checked_steps(
        gmodel, tcfg, gparams, synthetic_batches(dev, gcfg, B, S, 3),
        f"paper {gcfg.name}", sync)
    got = launch_counts()
    if any(n_ for k_, n_ in got.items() if not k_.startswith("FA")):
        raise PhaseError(f"paper full: launched {got}, expected no adapter "
                         "kernel (attention's FA/FAb aside)")
    after = tree_leaves(state["trainable"]["base"])
    still = sum(torch.equal(a, b) for a, b in zip(after, before))
    if len(after) != len(before) or still:
        raise PhaseError(f"paper full: {still} of {len(before)} base leaves "
                         "never moved")
    full = {"trainables": gmodel.trainable_params(), "losses": losses_g,
            "warm_ms": 1e3 * sum(secs_g[1:]) / len(secs_g[1:]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"[paper] {gcfg.name} full fine-tuning ({gcfg.dtype}): "
          f"{full['trainables']:,} trainables in {len(after)} leaves, 3 "
          f"steps, losses {[round(x, 4) for x in losses_g]}, every base "
          f"leaf moved, no kernel launch | warm {full['warm_ms']:.1f} "
          f"ms/step, peak device memory {full['peak_gib']:.2f} GiB")
    out["full"] = full
    del state, gparams, before, after, gmodel
    torch.cuda.empty_cache()

    # ---- d. --strategy factored on phase 7's model --------------------------
    fcfg = cfgs["factored"]
    factored = fpeft.replace(strategy="factored")
    fmodel = build(fcfg, factored)
    fparams = fmodel.init(0, dev)
    bs = synthetic_batches(dev, fcfg, B, S, 3)
    tcfg = TrainConfig(learning_rate=1e-2, total_steps=3, warmup_steps=1)
    zero_counts()
    state, _, losses_f, secs_f = checked_steps(
        fmodel, tcfg, fparams, bs, f"paper {fcfg.name}", sync)
    got = launch_counts()
    if any(n_ for k_, n_ in got.items() if not k_.startswith("FA")):
        raise PhaseError(f"paper factored train: launched {got}, expected "
                         "no adapter kernel (attention's FA/FAb aside)")
    if not c_moved(state, fparams):
        raise PhaseError("paper factored train: the coefficients never "
                         "moved")
    del state, fparams
    # the f32 gradient w.r.t. c at the first batch: factored against the
    # merged step's (K1 forward, K2 backward), within 1e-4 of the
    # gradient's own size (norm-relative, and each entry against max |g|);
    # not counted
    cfg32 = fcfg.replace(dtype="float32", param_dtype="float32")
    p32 = build(cfg32, fpeft).init(0, dev)
    grads = {}
    for strategy in ("factored", "merged"):
        m_ = build(cfg32, fpeft.replace(strategy=strategy))
        tr_, fr_ = train_step.split_params(m_, p32)
        _, g_ = train_step._value_and_grad(train_step._loss_for(m_), tr_,
                                           fr_, bs[0])
        grads[strategy] = torch.cat([g_["peft"][s_]["c"].flatten()
                                     for s_ in sorted(g_["peft"])])
    g = grads["merged"]
    diff = (grads["factored"] - g).abs()
    g_max, g_norm = float(g.abs().max()), float(g.norm())
    rel = float(diff.norm()) / g_norm if g_norm > 0 else math.inf
    if rel > 1e-4 or float(diff.max()) > 1e-4 * g_max:
        raise PhaseError(f"paper factored: the f32 c gradient differs from "
                         f"the merged step's by {float(diff.max()):.3e} "
                         f"(max |g| {g_max:.3e}), norm-relative {rel:.3e}; "
                         "limits 1e-4 of max |g| and 1e-4 of the norm")
    out["factored"] = {"losses": losses_f,
                       "warm_ms": 1e3 * sum(secs_f[1:]) / len(secs_f[1:]),
                       "grad_max_abs_diff": float(diff.max()),
                       "grad_max_abs": g_max, "grad_rel_diff": rel}
    print(f"[paper] {fcfg.name} {fcfg.num_layers} layers, --strategy "
          f"factored: 3 steps, losses {[round(x, 4) for x in losses_f]}, c "
          f"moved, no kernel launch, warm {out['factored']['warm_ms']:.1f} "
          f"ms/step | f32 first-batch c gradient vs the merged step's: max "
          f"|diff| {float(diff.max()):.3e} of max |g| {g_max:.3e}, "
          f"norm-relative {rel:.2e} (limits 1e-4 each)")
    del p32, grads, g
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[paper] phase 16 took {out['phase_s']:.1f} s")
    print(json.dumps({"paper": {"llama2_7b": llama, **out}}))
    return out


async def http_request(port: int, method: str, path: str, payload=None,
                       first_frame_only: bool = False):
    """One HTTP/1.1 exchange with the gateway on 127.0.0.1 (stdlib asyncio
    client): (status, body). With `first_frame_only` the client reads the
    response head and one SSE frame, then closes the socket (a client that
    walks away mid-stream)."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = b"" if payload is None else json.dumps(payload).encode()
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n"
                  f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                  ).encode() + body)
    await writer.drain()
    if first_frame_only:
        head = await reader.readuntil(b"\r\n\r\n")
        frame = await reader.readuntil(b"\n\n")
        writer.close()
        return int(head.split()[1]), frame
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


def sse_tokens(body: bytes):
    """SSE body -> (token ids, finish_reason, saw [DONE])."""
    tokens, finish, done = [], None, False
    for line in body.split(b"\n"):
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        data = line[len(b"data: "):]
        if data == b"[DONE]":
            done = True
            continue
        choice = json.loads(data)["choices"][0]
        if "token_id" in choice:
            tokens.append(int(choice["token_id"]))
        if choice.get("finish_reason") is not None:
            finish = choice["finish_reason"]
    return tokens, finish, done


def tiering_phase(dev, cfg, ps: int, sync) -> dict:
    """Phase 17 (module docstring) on `dev`, over phase 7's model config
    `cfg` (yi-6b full width, SLICE_LAYERS layers) and page size. `sync`
    waits for the device. Returns K3's launches by part; raises PhaseError
    when a check fails."""
    import argparse
    import asyncio
    import gc
    import shutil
    import statistics
    import threading
    import numpy as np
    import torch
    from repro_torch.checkpoint import adapters as adapter_ckpt
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.launch import api as launch_api
    from repro_torch.launch.serve import demo_prompts, demo_trace
    from repro_torch.models import build
    from repro_torch.serve import (AdapterBank, ContinuousScheduler, Engine,
                                   Request, TieringConfig)
    from repro_torch.serve.gateway import GatewayServer, protocol
    t_phase = time.perf_counter()
    L = cfg.num_layers
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    out = {"k3": {}}
    fdk.launches = 0
    model = build(cfg32, PEFTConfig(method="fourierft", n=1000, alpha=300.0))
    engine = Engine(model, model.init(0, dev), batch_slots=3, max_len=128,
                    device=dev)
    if fdk.launches != 2:
        raise PhaseError(f"tiering: the merge launched K1 {fdk.launches} "
                         "times, expected one per site (2)")
    out["k1_merge"] = fdk.launches
    print(f"[tiering] yi-6b full width, {L} layers, float32 (TF32 off), "
          "FourierFT n = 1000, alpha = 300 on wq/wv merged by K1; 3 slots, "
          f"page {ps}, max_len 128")

    # ---- a. preempt and resume under a constrained page pool ---------------
    # 11 pages: 3 scratch + 8 = 128 rows; each long (prompt + budget - 1 =
    # 64 rows) owns 4, so the two longs own the pool and every interactive
    # arrival must preempt one of them
    def trace():
        rows = [([(7 * j + 101) % cfg.vocab for j in range(9)], 56, "batch"),
                ([(11 * j + 203) % cfg.vocab for j in range(6)], 59, "batch")]
        arrivals = [0.0, 0.0]
        for i in range(3):
            rows.append(([301 + i, 302, 303], 6, "interactive"))
            arrivals.append(5.0 + 9.0 * i)
        return ([Request(prompt=torch.tensor(p, dtype=torch.int32),
                         max_new=n, priority=pr) for p, n, pr in rows],
                arrivals)

    pak.launches = 0
    base_sched = ContinuousScheduler(engine, page_size=ps)
    base = trace()[0]
    base_sched.serve(base, trace()[1])
    sync()
    if pak.launches != base_sched.metrics.steps * L:
        raise PhaseError(f"tiering base run: K3 launched {pak.launches} "
                         f"times, expected {base_sched.metrics.steps} x {L}")
    base = [r.out for r in base]
    del base_sched
    runs = {}
    for mode in ("swap", "recompute", "auto"):
        sched = ContinuousScheduler(
            engine, page_size=ps, n_pages=11,
            tiering=TieringConfig(mode=mode,
                                  host_kv_pages=0 if mode == "recompute"
                                  else 64))
        spilled, restored, popping = {}, [], []
        if sched.host_kv is not None:
            # hold every swap-resume's fill against the pages its
            # preemption gathered, read back right after the fill
            real_put = sched.host_kv.put_snapshot
            real_pop = sched.host_kv.pop_snapshot
            real_fill = sched._fill_pages

            def put(rid, k, v, n, real_put=real_put):
                spilled[rid] = (k.clone(), v.clone(), n)
                return real_put(rid, k, v, n)

            def pop(rid, real_pop=real_pop):
                popping.append(rid)
                return real_pop(rid)

            def fill(k, v, idx, real_fill=real_fill, sched=sched):
                real_fill(k, v, idx)
                if not popping:
                    return                       # a prefix promotion
                sk, sv, n = spilled.pop(popping.pop())
                i = torch.as_tensor(idx[:n], dtype=torch.int64, device=dev)
                if not (torch.equal(sched.cache["pk"].index_select(1, i),
                                    sk[:, :n])
                        and torch.equal(sched.cache["pv"].index_select(1, i),
                                        sv[:, :n])):
                    raise PhaseError(f"tiering {mode}: the filled pages "
                                     "differ from the spilled pages")
                restored.append(n)

            sched.host_kv.put_snapshot = put
            sched.host_kv.pop_snapshot = pop
            sched._fill_pages = fill
        pak.launches = 0
        reqs, arrivals = trace()
        sched.serve(reqs, arrivals)
        sync()
        # drop the checks' hooks: each closes over its owner, and the cycle
        # would keep the scheduler's engine alive past the phase
        sched.__dict__.pop("_fill_pages", None)
        if sched.host_kv is not None:
            for name in ("put_snapshot", "pop_snapshot"):
                sched.host_kv.__dict__.pop(name)
        outs = [r.out for r in reqs]
        s = sched.metrics.summary()
        if outs != base:
            raise PhaseError(f"tiering {mode}: streams {outs} differ from "
                             f"the untiered run's {base}")
        if pak.launches != sched.metrics.steps * L:
            raise PhaseError(f"tiering {mode}: K3 launched {pak.launches} "
                             f"times, expected {sched.metrics.steps} x {L}")
        sched.pager.assert_no_leaks()
        if sched.host_kv is not None and sched.host_kv._snapshots:
            raise PhaseError(f"tiering {mode}: snapshots left in the host "
                             "pool")
        if s["preemptions_total"] < 1 or s["resumed_total"] < 1:
            raise PhaseError(f"tiering {mode}: no preempt and resume ({s})")
        if mode != "recompute" and s["preempt_swap_total"] >= 1 and not (
                s["kv_pages_spilled_total"] >= 1 and restored
                and s["kv_pages_filled_total"] >= 1):
            raise PhaseError(f"tiering {mode}: swaps without pages spilled "
                             f"and filled back ({s}, {restored})")
        runs[mode] = {k: s[k + "_total"] for k in (
            "preemptions", "preempt_swap", "preempt_recompute", "resumed",
            "kv_pages_spilled", "kv_pages_filled")}
        runs[mode].update(steps=sched.metrics.steps, k3=pak.launches,
                          fills_held_bitwise=len(restored))
        out["k3"][f"preempt_{mode}"] = pak.launches
        print(f"[tiering] {mode}: streams equal the untiered run's | "
              f"{runs[mode]} | no page leaked, no snapshot left")
        del sched
    if not (sum(r["preempt_swap"] for r in runs.values()) >= 1
            and sum(r["preempt_recompute"] for r in runs.values()) >= 1):
        raise PhaseError(f"tiering: the runs made no swap or no recompute "
                         f"({runs})")
    out["preempt"] = runs

    # ---- b. host tiers: prefix pages and adapter rows ----------------------
    # 2 slots, 10 pages (2 scratch + 8): the long middle request needs all
    # 8, so the shared prompt's two cached chunks demote to the host, and
    # its return promotes them back
    engine2 = Engine(engine.model, engine.params, batch_slots=2, max_len=128,
                     device=dev)
    shared = [(13 * j + 5) % cfg.vocab for j in range(33)]

    def prefix_trace():
        return ([Request(prompt=torch.tensor(p, dtype=torch.int32),
                         max_new=n)
                 for p, n in ((shared, 4), ([21, 22, 23, 24, 25], 124),
                              (shared, 4))], [0.0, 20.0, 200.0])

    ref = prefix_trace()[0]
    ContinuousScheduler(engine2, page_size=ps).serve(ref, prefix_trace()[1])
    psched = ContinuousScheduler(engine2, page_size=ps, n_pages=10,
                                 tiering=TieringConfig(host_kv_pages=16))
    preqs = prefix_trace()[0]
    psched.serve(preqs, prefix_trace()[1])
    sync()
    s = psched.metrics.summary()
    if [r.out for r in preqs] != [r.out for r in ref]:
        raise PhaseError("tiering prefix: streams differ from the "
                         "unconstrained run's")
    if s["kv_pages_spilled_total"] < 1 or s["prefix_host_hits_total"] < 1:
        raise PhaseError(f"tiering prefix: no demotion or no host hit ({s})")
    psched.pager.assert_no_leaks()
    out["prefix"] = {k: s[k + "_total"] for k in (
        "kv_pages_spilled", "kv_pages_filled", "prefix_host_hits",
        "kv_fills_degraded")}
    out["prefix"]["cold_equals_warm"] = preqs[0].out == preqs[2].out
    print(f"[tiering] prefix pages: {out['prefix']} | streams equal the "
          "unconstrained run's")
    del psched, engine2, ref

    # phase 13's tenants over a bank of capacity 2 with a host tier of 5
    # rows, against a bank of capacity 5 (no eviction)
    bmodel = build(cfg32, PEFTConfig(method="none"))
    bparams = bmodel.init(0, dev)
    tenant_dir = Path(__file__).resolve().parent / "build" / "smoke_tenants"
    profiles, tenant_ids = bank_tenants(dev, bmodel, bparams, tenant_dir)
    prompts8 = demo_prompts(cfg, 8)

    def bank_run(capacity, tiering):
        bank = AdapterBank(bmodel, profiles, capacity=capacity,
                           checkpoint_dir=str(tenant_dir), device=dev)
        eng = Engine(bmodel, bparams, batch_slots=8, max_len=128, bank=bank,
                     device=dev)
        sched = ContinuousScheduler(eng, page_size=ps, tiering=tiering)
        return bank, sched

    _, rsched = bank_run(5, None)
    rreqs, arrivals = demo_trace(prompts8, 12, 16, 2.0, tenant_ids + [None])
    rsched.serve(rreqs, arrivals)
    bank, bsched = bank_run(2, TieringConfig(host_adapter_slots=5,
                                             preempt=False))
    checked = []
    real_host = bank.load_from_host

    def load_from_host(aid, pinned=()):
        slot = real_host(aid, pinned=pinned)
        if slot is not None:
            tree, prof = adapter_ckpt.import_adapter(str(tenant_dir), aid,
                                                     device=dev)
            rows = bank.params[prof.method]["sites"]
            for site, leaves in tree.items():
                for leaf, v in leaves.items():
                    if not torch.equal(rows[site][leaf][slot], v):
                        raise PhaseError(f"tiering bank: {aid} {site}/{leaf}"
                                         " reloaded from the host differs "
                                         "from its checkpoint")
            checked.append(aid)
        return slot

    bank.load_from_host = load_from_host
    breqs, _ = demo_trace(prompts8, 12, 16, 2.0, tenant_ids + [None])
    bsched.serve(breqs, arrivals)
    sync()
    del bank.load_from_host
    s = bsched.metrics.summary()
    if [r.out for r in breqs] != [r.out for r in rreqs]:
        raise PhaseError("tiering bank: streams differ from the capacity-5 "
                         "bank's")
    if s["adapter_host_hits_total"] < 1 or not checked:
        raise PhaseError(f"tiering bank: no host hit ({s})")
    out["bank"] = {"adapter_spills": s["adapter_spills_total"],
                   "adapter_host_hits": s["adapter_host_hits_total"],
                   "rows_held_bitwise": len(checked),
                   "checkpoint_loads": bank.loads - len(checked)}
    print(f"[tiering] bank of capacity 2, host tier of 5 rows, 5 tenants + "
          f"None: {out['bank']} | streams equal the capacity-5 bank's, "
          "every host reload bitwise its checkpoint")
    del bank, bsched, rsched, bparams, bmodel
    shutil.rmtree(tenant_dir, ignore_errors=True)

    # ---- c. cost: swap (spill + fill) against recompute (prefill) ---------
    csched = ContinuousScheduler(engine, page_size=ps,
                                 tiering=TieringConfig(host_kv_pages=64))
    n_pages, n_tok = 8, 8 * ps
    idx = np.arange(3, 3 + n_pages, dtype=np.int64)
    pool = csched.host_kv

    def swap_once():
        pool.put_snapshot(0, *csched._spill_pages(idx), n_pages)
        pool.settle()
        k, v, _ = pool.pop_snapshot(0)
        csched._fill_pages(k, v, idx)
        sync()

    toks = torch.randint(0, cfg.vocab, (1, n_tok), device=dev,
                         dtype=torch.int32)
    bt = torch.as_tensor(idx[None].astype(np.int32), device=dev)
    pbatch = {"tokens": toks, "block_table": bt, "slot": 0,
              "scratch_page": 0}

    @torch.no_grad()
    def prefill_once():
        csched.model.prefill_paged(engine.params, csched.cache, pbatch)
        sync()

    walls = {"swap": [], "prefill": []}
    for label in ("swap", "prefill", "prefill", "swap"):
        fn = swap_once if label == "swap" else prefill_once
        for _ in range(2):
            fn()
        for _ in range(6):
            t0 = time.perf_counter()
            fn()
            walls[label].append(time.perf_counter() - t0)
    swap_ms = statistics.median(walls["swap"]) * 1e3
    prefill_ms = statistics.median(walls["prefill"]) * 1e3
    page_bytes = 2 * L * ps * cfg.n_kv * cfg.head_dim * 4
    out["cost"] = {
        "pages": n_pages, "tokens": n_tok, "page_bytes": page_bytes,
        "swap_ms": swap_ms, "prefill_ms": prefill_ms,
        "swap_ms_per_page": swap_ms / n_pages,
        "prefill_ms_per_token": prefill_ms / n_tok,
        # TieringConfig.swap_cost_per_token: one direction of the move per
        # token, in recomputed-token units
        "swap_cost_per_token": (swap_ms / 2) / prefill_ms}
    print(f"[tiering] cost, {L} layers f32, {n_pages} pages ({n_tok} "
          f"tokens, {page_bytes} bytes a page): spill + fill "
          f"{swap_ms:.3f} ms ({swap_ms / n_pages:.4f} ms a page) against a "
          f"prefill of the same tokens {prefill_ms:.3f} ms "
          f"({prefill_ms / n_tok * 1e3:.2f} us a token): one direction of "
          f"the move costs {out['cost']['swap_cost_per_token']:.3f} "
          "recomputed tokens per token (TieringConfig.swap_cost_per_token "
          "= 0.125)")
    del csched, pool

    # ---- d. the gateway over a tiered scheduler from the launcher's flags --
    flags = ["--arch", "yi-6b", "--layers", str(L), "--dtype", "float32",
             "--slots", "4", "--max-len", "128", "--page-size", str(ps),
             "--preempt", "--preempt-mode", "swap", "--host-kv-pages", "64",
             "--device", dev.type]
    ap = argparse.ArgumentParser()
    launch_api.add_model_args(ap)
    args = ap.parse_args(flags)
    gsched, _ = launch_api.build_scheduler(args)
    server = GatewayServer(gsched, max_queue=64)
    treqs, _ = demo_trace(prompts8, 8, 16, 2.0)
    batch_payloads = [{"model": "base", "prompt": r.prompt.tolist(),
                       "max_tokens": r.max_new, "stream": True}
                      for r in treqs]
    chat_payloads = [{"model": "base", "stream": True, "max_tokens": 6,
                      "priority": "interactive",
                      "messages": [{"role": "user", "content": text}]}
                     for text in ("tier me", "and me")]
    threads = set()
    real_decode = gsched.model.decode_step

    def decode_step(*a, **kw):
        threads.add(threading.get_ident())
        return real_decode(*a, **kw)

    gsched.model.decode_step = decode_step

    pump = {}

    async def drive():
        await server.start("127.0.0.1", 0)
        port, bridge = server.port, server.bridge
        pump["ident"] = bridge._thread.ident
        try:
            batch = [asyncio.ensure_future(http_request(
                port, "POST", "/v1/completions", p)) for p in batch_payloads]
            walker = asyncio.ensure_future(http_request(
                port, "POST", "/v1/completions",
                {"model": "base", "prompt": [5, 6, 7], "max_tokens": 40,
                 "stream": True}, first_frame_only=True))
            gate, entered = threading.Event(), threading.Event()

            def hold_if_full():
                # hold the pump between ticks while every slot decodes, so
                # the interactive requests arrive to a full batch
                if gsched.metrics.steps < 2 or gsched.slots.free_slots():
                    return False
                entered.set()
                return gate.wait(timeout=60)

            for _ in range(5000):
                held = bridge.call(hold_if_full)
                while not entered.is_set() and not held.done():
                    await asyncio.sleep(0.0005)
                if entered.is_set():
                    break
                await asyncio.sleep(0.001)
            else:
                raise PhaseError("tiering gateway: the slots never filled")
            chats = [asyncio.ensure_future(http_request(
                port, "POST", "/v1/chat/completions", p))
                for p in chat_payloads]
            while bridge._cmds.qsize() < len(chats):
                await asyncio.sleep(0.0005)
            gate.set()
            await held
            got = await asyncio.gather(*batch, *chats)
            await walker
            while await bridge.call(lambda: gsched.slots.any_active()):
                await asyncio.sleep(0.005)
            await bridge.call(gsched.pager.assert_no_leaks)
            state = await bridge.call(lambda: (
                gsched.metrics.steps, len(gsched.host_kv._snapshots),
                gsched.metrics.summary()))
            _, metrics = await http_request(port, "GET", "/metrics")
            return got, state, metrics.decode()
        finally:
            await server.close()

    pak.launches = 0
    got, (steps, snaps, gs), metrics = asyncio.run(drive())
    k3_gateway = pak.launches
    del gsched.model.decode_step
    streams = []
    for status, body in got:
        toks_, finish, done = sse_tokens(body)
        if status != 200 or not done or finish != "length":
            raise PhaseError(f"tiering gateway: a stream ended {status} "
                             f"{finish} {done}")
        streams.append(toks_)
    vocab, max_len = cfg.vocab, 128
    replay = [Request(prompt=r.prompt, max_new=r.max_new) for r in treqs]
    for p in chat_payloads:
        preq = protocol.parse_request("chat", p, vocab=vocab,
                                      max_len=max_len)
        replay.append(Request(prompt=torch.tensor(preq.prompt,
                                                  dtype=torch.int32),
                              max_new=preq.max_new))
    rsched, _ = launch_api.build_scheduler(args)
    rsched.serve(replay)
    if streams != [r.out for r in replay]:
        raise PhaseError(f"tiering gateway: streams {streams} differ from "
                         f"the in-process replay {[r.out for r in replay]}")
    if k3_gateway != steps * L or not k3_gateway:
        raise PhaseError(f"tiering gateway: K3 launched {k3_gateway} times, "
                         f"expected {steps} decode steps x {L}")
    if threads != {pump['ident']}:
        raise PhaseError("tiering gateway: decode ran off the pump thread")
    values = dict(ln.rsplit(" ", 1) for ln in metrics.splitlines()
                  if ln and not ln.startswith("#") and "{" not in ln)
    need = ("repro_preemptions_total", "repro_preempt_swap_total",
            "repro_resumed_total", "repro_kv_pages_spilled_total",
            "repro_host_kv_pages_used", "repro_host_kv_pages_capacity")
    if any(k not in values for k in need) \
            or float(values["repro_preemptions_total"]) < 1 \
            or float(values["repro_host_kv_pages_capacity"]) != 64:
        raise PhaseError(f"tiering gateway: /metrics lacks the preemptions "
                         f"or the host-tier gauges: {values}")
    if gs["requests_cancelled_total"] < 1 or snaps:
        raise PhaseError("tiering gateway: the disconnect was not cancelled "
                         "or a snapshot was left")
    out["gateway"] = {"streams": len(streams), "decode_steps": steps,
                      "k3": k3_gateway,
                      **{k: float(values[k]) for k in need},
                      "cancelled": gs["requests_cancelled_total"]}
    out["k3"]["gateway"] = k3_gateway
    print(f"[tiering] gateway (launch.api flags {' '.join(flags)}): "
          f"{len(streams)} SSE streams (8 /v1/completions of the launcher's "
          "trace, 2 interactive /v1/chat/completions) equal the in-process "
          "replay; a client that left mid-stream was cancelled, no page "
          f"leaked; K3 launched {k3_gateway} = {steps} steps x {L} on the "
          f"pump thread; /metrics: preemptions "
          f"{values['repro_preemptions_total']}, swaps "
          f"{values['repro_preempt_swap_total']}, host KV pages used "
          f"{values['repro_host_kv_pages_used']} of "
          f"{values['repro_host_kv_pages_capacity']}")
    del rsched, server, gsched, engine, model
    # asyncio's closed loop, transports and protocols form reference cycles
    # that reach the gateway (and this frame, so every model above) until
    # the cyclic collector runs
    gc.collect()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[tiering] phase 17 took {out['phase_s']:.1f} s")
    print(json.dumps({"tiering": out}))
    return out


FUSED_SHAPE = (8, 1024, 32, 4, 128)   # sft1k's: B, S, H, K, dh (yi-6b)
FUSED_REL = 1e-2                      # kernel vs plain, relative (norm)
FUSED_LSE = 1e-4                      # kernel vs plain lse, absolute


def fused_attention_phase(dev, shape, timed_ms, sync) -> dict:
    """The fused attention kernel alone at `shape` (B, S, H, K, dh), bf16,
    causal: held to its plain version on the same inputs (out and the
    gradients within FUSED_REL of the plain version's norm, lse within
    FUSED_LSE), then CUDA-event ms of the kernel's forward and
    forward+backward, its device ms by CUDA kernel, the plain version's,
    the direct path's (what the route replaced), and SDPA's (the
    yardstick, never on the port's path), against the bound: operations,
    4·H·dh a visible (row, column) pair forward and three times that
    forward+backward (`harness/flops.py`'s count)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_attention as fa
    from repro_torch.models import attention as attn
    B, S, H, K, dh = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*s_):
        return torch.randn(s_, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, k, v, do = randn(B, S, H, dh), randn(B, S, K, dh), randn(B, S, K, dh), \
        randn(B, S, H, dh)
    before = (fa.launches, fa.bwd_launches)
    out, lse = fa._fwd_launch(q, k, v, True)
    grads = fa._bwd_launch(q, k, v, out, lse, do, True)
    sync()
    p_out, p_lse = fa.reference_forward(q, k, v, True)
    p_grads = fa.reference_backward(q, k, v, p_out, p_lse, do, True)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    errs = {"out": rel(out, p_out), "lse": float((lse - p_lse).abs().max())}
    errs.update({n_: rel(a, b) for n_, a, b in
                 zip(("dq", "dk", "dv"), grads, p_grads)})
    del p_out, p_lse, p_grads
    torch.cuda.empty_cache()
    bad = [n_ for n_, e in errs.items()
           if e > (FUSED_LSE if n_ == "lse" else FUSED_REL)]
    if bad or (fa.launches, fa.bwd_launches) != (before[0] + 1,
                                                 before[1] + 1):
        raise PhaseError(f"fused attention at {shape}: {errs} (limits "
                         f"{FUSED_REL} relative, lse {FUSED_LSE}); launches "
                         f"{fa.launches - before[0]}, "
                         f"{fa.bwd_launches - before[1]}")

    def forward(fn):
        return lambda: fn(q, k, v)

    def fwd_bwd(fn):
        xs = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def run():
            torch.autograd.grad(fn(*xs), xs, do)
        return run

    def kernel(*x):
        return fa.fused_attention(*x, True)

    def direct(*x):
        return attn.direct_attention(*x, causal=True)

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    def plain_fb():
        o_, l_ = fa.reference_forward(q, k, v, True)
        fa.reference_backward(q, k, v, o_, l_, do, True)

    ms = {"ms": timed_ms(forward(kernel), 20),
          "fb_ms": timed_ms(fwd_bwd(kernel), 10),
          "plain_ms": timed_ms(lambda: fa.reference_forward(q, k, v, True),
                               3, 1),
          "plain_fb_ms": timed_ms(plain_fb, 2, 1),
          "direct_ms": timed_ms(forward(direct), 3, 1),
          "direct_fb_ms": timed_ms(fwd_bwd(direct), 2, 1),
          "library_ms": timed_ms(forward(sdpa), 20),
          "library_fb_ms": timed_ms(fwd_bwd(sdpa), 10)}
    ops = 4.0 * H * dh * B * S * (S + 1) / 2
    nbytes = 2.0 * (2 * q.numel() + 2 * k.numel()) + 4.0 * B * H * S
    b_ms, b_by = bound(ops, nbytes, "bfloat16")
    fb_ms, _ = bound(3 * ops, 2 * nbytes, "bfloat16")
    dev_ms, n_kernels, top = device_ms(fwd_bwd(kernel), 3)
    fig = {"shape": list(shape), "errs": errs, **ms, "bound_ms": b_ms,
           "bound_by": b_by, "fb_bound_ms": fb_ms,
           "tflops": ops / ms["ms"] * 1e-9,
           "fb_tflops": 3 * ops / ms["fb_ms"] * 1e-9,
           "device_fb_ms": dev_ms, "device_kernels": n_kernels,
           "device_top": top}
    print(f"[fused] B {B} S {S} H {H} K {K} dh {dh}, causal bf16: kernel "
          f"vs plain {errs} | forward {ms['ms']:.3f} ms "
          f"({fig['tflops']:.0f} TF/s; bound {b_ms:.3f}, {b_by}), "
          f"forward+backward {ms['fb_ms']:.3f} ms ({fig['fb_tflops']:.0f} "
          f"TF/s; bound {fb_ms:.3f}) | plain {ms['plain_ms']:.3f} / "
          f"{ms['plain_fb_ms']:.3f} | direct {ms['direct_ms']:.3f} / "
          f"{ms['direct_fb_ms']:.3f} | SDPA {ms['library_ms']:.3f} / "
          f"{ms['library_fb_ms']:.3f} | device by kernel {top}")
    return fig


def long_attention_phase(dev, geometry, timed_ms, sync) -> dict:
    """Phase 18a (module docstring) on `dev` at `geometry` (H, K, dh, S).
    Returns each dtype's readings, times and peak memory; raises
    PhaseError when a check fails."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import attention as attn
    gib = 2 ** 30

    def peak_above(fn):
        """(result, peak device memory above what was allocated before,
        GiB)."""
        sync()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        sync()
        return res, (torch.cuda.max_memory_allocated() - before) / gib

    def flash(q_, k_, v_):
        return attn.flash_attention(q_, k_, v_, True, 512)

    def chunked(q_, k_, v_):
        return attn.chunked_attention(q_, k_, v_, causal=True)

    def direct(q_, k_, v_):
        return attn.direct_attention(q_, k_, v_, causal=True)

    def vec_rel(a, b):
        """max over output vectors (row, head) of max |a - b| over the
        vector's largest |b|."""
        return float(((a - b).abs().amax(-1)
                      / b.abs().amax(-1).clamp_min(1e-30)).max())

    def tensor_rel(a, b):
        """(max |a - b| / max |b|, ||a - b|| / ||b||) of each pair."""
        return ([float((x - y).abs().max() / y.abs().max())
                 for x, y in zip(a, b)],
                [float((x - y).norm() / y.norm()) for x, y in zip(a, b)])

    def worst_abs(a, b):
        return [float((x - y).abs().max()) for x, y in zip(a, b)]

    H, K, dh, S = geometry
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
        q32 = torch.randn((1, S, H, dh), generator=gen, device=dev)
        k32 = torch.randn((1, S, K, dh), generator=gen, device=dev)
        v32 = torch.randn((1, S, K, dh), generator=gen, device=dev)
        cot32 = torch.randn((1, S, H, dh), generator=gen, device=dev)
        q, k, v, cot = (x.to(dtype) for x in (q32, k32, v32, cot32))

        def grads(fn, xs=(q, k, v), dt=None, c=cot):
            """(output, gradients of sum(output * c)) of fn on xs (cast to
            `dt` when given), in float64."""
            xs = [x.detach().to(dt or x.dtype).requires_grad_(True)
                  for x in xs]
            with torch.enable_grad():
                o = fn(*xs)
                g_ = torch.autograd.grad((o * c.to(o.dtype)).sum(), xs)
            return o.detach().double(), [x.double() for x in g_]

        # every path against the exact value of the function on these
        # inputs and this cotangent (in `dtype`): direct attention in
        # float64. (f32 direct itself strays from it by up to 1.2e-4 in dv
        # at this length on the card, beyond the 5e-5 the CPU suite holds
        # flash to against it at S 512, so an f32-to-f32 comparison would
        # test direct's rounding, not flash.)
        o64, g64 = grads(direct, dt=torch.float64)
        of, gf = grads(flash)
        od, gd = grads(direct)
        with torch.no_grad():
            oc = chunked(q, k, v).double()
        rec = {"max_grad": [float(g.abs().max()) for g in g64],
               "grad_abs": worst_abs(gf, g64),
               "direct_grad_abs": worst_abs(gd, g64)}
        rec["grad_rel"], rec["grad_norm"] = tensor_rel(gf, g64)
        rec["direct_grad_rel"], rec["direct_grad_norm"] = tensor_rel(gd, g64)
        if dtype == torch.float32:
            # the CPU suite's tolerances: forward 3e-6, gradients 5e-5
            # (every tensor), chunked 2e-5
            rec.update(fwd=worst_abs([of], [o64])[0],
                       chunked=worst_abs([oc], [o64])[0],
                       direct_fwd=worst_abs([od], [o64])[0])
            limits = {"fwd": 3e-6, "chunked": 2e-5}
            ok = (rec["fwd"] <= 3e-6 and rec["chunked"] <= 2e-5
                  and max(rec["grad_abs"]) <= 5e-5)
            what = (f"forward {rec['fwd']:.3e} (limit 3e-6), chunked "
                    f"{rec['chunked']:.3e} (2e-5), dq/dk/dv "
                    f"{[f'{x:.3e}' for x in rec['grad_abs']]} (5e-5 each)")
        else:
            # bf16, each tensor against its own size: every output vector
            # within 6e-3 of its largest |value| (the bf16 cast alone is
            # within 2^-8 = 3.9e-3), every gradient ||diff|| / ||g||
            # <= 2.5e-3 and max |diff| / max |g| <= 2e-2. The control: the
            # same outputs against the f32 problem before the inputs were
            # rounded to bf16 (float64 direct on the f32 inputs and
            # cotangent), which a sound bf16 flash cannot reach; its
            # reading must stay above the limits for them to mean anything
            rec.update(fwd=vec_rel(of, o64), chunked=vec_rel(oc, o64),
                       direct_fwd=vec_rel(od, o64))
            o64c, g64c = grads(direct, (q32, k32, v32), torch.float64, cot32)
            rec["control_fwd"] = vec_rel(of, o64c)
            rec["control_grad_rel"], rec["control_grad_norm"] = tensor_rel(
                gf, g64c)
            del o64c, g64c
            limits = {"fwd": 6e-3, "chunked": 6e-3, "grad_norm": 2.5e-3,
                      "grad_rel": 2e-2}
            ok = (rec["fwd"] <= 6e-3 and rec["chunked"] <= 6e-3
                  and max(rec["grad_norm"]) <= 2.5e-3
                  and max(rec["grad_rel"]) <= 2e-2)
            what = (f"forward {rec['fwd']:.3e} of each vector's largest "
                    f"(limit 6e-3; control {rec['control_fwd']:.3e}), "
                    f"chunked {rec['chunked']:.3e} (6e-3), dq/dk/dv "
                    f"||diff||/||g|| "
                    f"{[f'{x:.3e}' for x in rec['grad_norm']]} (2.5e-3; "
                    f"control "
                    f"{[f'{x:.3e}' for x in rec['control_grad_norm']]}), "
                    f"max |diff|/max |g| "
                    f"{[f'{x:.3e}' for x in rec['grad_rel']]} (2e-2)")
        rec["limits"] = limits
        del o64, g64, of, gf, od, gd, oc
        if not ok:
            raise PhaseError(f"families attention {dname} S {S}: flash "
                             f"against float64 direct_attention: {what}")
        # SDPA, the library call for the same causal GQA product (not on
        # the port's path): GQA through enable_gqa where this torch takes
        # it, else heads expanded inside the timed call
        try:
            F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
            sdpa_gqa, sdpa_how = True, "enable_gqa"
        except (RuntimeError, TypeError):
            sdpa_gqa, sdpa_how = False, "expanded heads"

        def sdpa_fn(q_, k_, v_, gqa=sdpa_gqa):
            if not gqa:
                k_, v_ = (x.repeat_interleave(H // K, dim=2)
                          for x in (k_, v_))
            kw = {"enable_gqa": True} if gqa else {}
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                is_causal=True, **kw).transpose(1, 2)

        rec["sdpa"] = sdpa_how
        iters = 3
        for label, fn in (("flash", flash), ("chunked", chunked),
                          ("direct", direct), ("sdpa", sdpa_fn)):
            with torch.no_grad():
                _, mem = peak_above(lambda: fn(q, k, v))
                rec[f"{label}_ms"] = timed_ms(lambda: fn(q, k, v), iters)
            rec[f"{label}_peak_gib"] = mem
            if label != "chunked":       # autograd keeps every block there
                _, mem_b = peak_above(lambda: grads(fn))
                rec[f"{label}_fwd_bwd_ms"] = timed_ms(lambda: grads(fn),
                                                      iters)
                rec[f"{label}_fwd_bwd_peak_gib"] = mem_b
        # the bound of the same causal product at this dtype's rate: 2·S²·H·dh
        # operations forward (half of QKᵀ and of PV), 2.5 times that
        # backward; q, k, v and o once forward, and do, dq, dk, dv besides
        elt = 2 if dtype == torch.bfloat16 else 4
        flops = 2.0 * S * S * H * dh
        io = elt * (2 * S * H * dh + 2 * S * K * dh)
        rec["bound_ms"], rec["bound_by"] = bound(flops, io, dname)
        rec["fwd_bwd_bound_ms"], rec["fwd_bwd_bound_by"] = bound(
            3.5 * flops, 2 * io, dname)
        res[dname] = rec
        print(f"[families] attention {dname} bound: forward "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), forward+"
              f"backward {rec['fwd_bwd_bound_ms']:.4f} ms; flash "
              f"{rec['flash_ms'] / rec['bound_ms']:.1f}x and "
              f"{rec['flash_fwd_bwd_ms'] / rec['fwd_bwd_bound_ms']:.1f}x it")
        print(f"[families] attention {dname} B 1 S {S} H {H} K {K} dh {dh}, "
              f"causal, against float64 direct: {what}; max |g| "
              f"{[round(x, 2) for x in rec['max_grad']]}; direct in {dname}: "
              f"forward {rec['direct_fwd']:.2e}, gradients "
              f"{[f'{x:.2e}' for x in rec['direct_grad_abs']]} abs, "
              f"{[f'{x:.2e}' for x in rec['direct_grad_norm']]} in norm "
              f"| forward ms: flash {rec['flash_ms']:.3f}, chunked "
              f"{rec['chunked_ms']:.3f}, direct {rec['direct_ms']:.3f}, "
              f"sdpa {rec['sdpa_ms']:.3f} ({sdpa_how}) | forward+backward "
              f"ms: flash {rec['flash_fwd_bwd_ms']:.3f}, direct "
              f"{rec['direct_fwd_bwd_ms']:.3f}, sdpa "
              f"{rec['sdpa_fwd_bwd_ms']:.3f} | peak GiB above the inputs, "
              f"forward: flash {rec['flash_peak_gib']:.3f}, chunked "
              f"{rec['chunked_peak_gib']:.3f}, direct "
              f"{rec['direct_peak_gib']:.3f}, sdpa {rec['sdpa_peak_gib']:.3f}"
              f"; forward+backward: flash {rec['flash_fwd_bwd_peak_gib']:.3f}"
              f", direct {rec['direct_fwd_bwd_peak_gib']:.3f}, sdpa "
              f"{rec['sdpa_fwd_bwd_peak_gib']:.3f}")
        if rec["flash_fwd_bwd_peak_gib"] >= rec["direct_fwd_bwd_peak_gib"]:
            raise PhaseError(f"families attention {dname}: flash's peak "
                             "memory is not below direct's")
        del q, k, v, cot, q32, k32, v32, cot32
        torch.cuda.empty_cache()
    return res


def families_phase(dev, cfgs, sizes, timed_ms, sync) -> dict:
    """Phase 18 (module docstring) on `dev`. `cfgs` maps each part to its
    model config ("olmoe", "olmoe2" the 2-layer copy held against the
    plain path, "phi", "musicgen", "qwen2vl"); `sizes` holds the
    attention geometry of 18a ("attn": (H, K, dh, S)) and each part's
    training (B, S) ("olmoe", "phi", "musicgen", "qwen2vl"). `timed_ms(fn,
    iters)` times on the card; `sync` waits for it. Returns the launch
    counts of each part's run by kernel and the part's figures; raises
    PhaseError when a check fails."""
    import torch
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.kernels import dct_deltaw as ddk
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.launch.serve import demo_prompts, demo_trace
    from repro_torch.models import attention as attn
    from repro_torch.models import build
    from repro_torch.serve import ContinuousScheduler, Engine
    from repro_torch.serve import merge_for_serving
    from repro_torch.tree import tree_leaves
    fpeft = PEFTConfig(method="fourierft", n=1000, alpha=300.0)
    out = {"launches": {}}
    t_phase = time.perf_counter()
    gib = 2 ** 30

    # ---- a. attention alone at yi-6b's heads, S 4096 ------------------------
    out["attention"] = long_attention_phase(dev, sizes["attn"], timed_ms,
                                            sync)

    # ---- shared: train steps and serving ----------------------------------
    def train(name, model, params, bs, sites=2, cluster_sites=0):
        """counted_train, flash expected once a layer a step at S > 1024;
        returns (state, frozen, figures)."""
        ref = bs[0].get("tokens", bs[0].get("embeds"))
        S_ = int(ref.shape[1])
        want = (len(bs) * model.cfg.num_layers
                if S_ > 1024 and S_ % 512 == 0 else 0)
        state, frozen, fig, got = counted_train(
            "families", name, model, params, bs, want, sync, sites,
            cluster_sites)
        out["launches"][name + "_train"] = got
        return state, frozen, fig

    def serve(name, model, params, slots, n_req, page=16, max_len=128):
        """Merge (K1) and the launcher's trace through the continuous
        paged scheduler (K3): every request completes, K3 launches decode
        steps x layers. Returns (engine, requests, figures)."""
        L = model.cfg.num_layers
        zero_counts()
        t0 = time.perf_counter()
        engine = Engine(model, params, batch_slots=slots, max_len=max_len,
                        device=dev)
        sync()
        merge_s = time.perf_counter() - t0
        k1 = fdk.launches
        sched = ContinuousScheduler(engine, page_size=page)
        reqs, arrivals = demo_trace(demo_prompts(model.cfg, slots), n_req,
                                    16, 2.0)
        pak.launches = 0
        sched.serve(reqs, arrivals)
        sync()
        k3, steps = pak.launches, sched.metrics.steps
        for i, r in enumerate(reqs):
            if r.out is None or len(r.out) != r.max_new:
                raise PhaseError(f"families {name} serve: request {i} "
                                 f"emitted {r.out!r}, budget {r.max_new}")
        if k1 != 2 or k3 != steps * L:
            raise PhaseError(f"families {name} serve: K1 launched {k1} "
                             f"times (expected 2), K3 {k3} (expected "
                             f"{steps} decode steps x {L})")
        s_ = sched.metrics.summary()
        out["launches"][name + "_serve"] = {"K1": k1, "K3": k3}
        print(f"[families] {name} serve: merge {merge_s:.3f} s (K1 {k1}), "
              f"{len(reqs)} requests, {s_['total_tokens']:.0f} tokens in "
              f"{steps} decode steps, {s_['tokens_per_s']:.1f} tok/s | K3 "
              f"launches {k3} (H {model.cfg.n_heads}, K {model.cfg.n_kv}: "
              f"G = {model.cfg.n_heads // model.cfg.n_kv})")
        return engine, reqs, {"merge_s": merge_s, "decode_steps": steps,
                              "serve_tokens_per_s": s_["tokens_per_s"]}

    def describe(name, cfg, params, cut=""):
        n_base = sum(t.numel() for t in tree_leaves(params["base"]))
        moe = (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of "
               f"{cfg.moe.d_ff_expert}" if cfg.moe is not None else "")
        print(f"[families] {name}: {cfg.name}, {cfg.num_layers} layers{cut}, "
              f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv} of "
              f"{cfg.head_dim}{moe}, vocab {cfg.vocab}, {cfg.dtype}; "
              f"{n_base:,} base parameters, "
              f"{torch.cuda.memory_allocated() / gib:.2f} GiB held")
        return n_base

    # ---- b. olmoe-1b-7b at full size --------------------------------------
    cfg = cfgs["olmoe"]
    model = build(cfg, fpeft)
    params = model.init(0, dev)
    n_base = describe("olmoe", cfg, params)
    B, S_ = sizes["olmoe"]
    state, frozen, fig = train("olmoe", model, params,
                               synthetic_batches(dev, cfg, B, S_, 3))
    fig["base_params"] = n_base
    # flash's share of the step: its forward and backward alone at the
    # step's attention shapes, times the layers, against the warm step
    qa = torch.randn((B, S_, cfg.n_heads, cfg.head_dim), device=dev,
                     dtype=torch.bfloat16)
    ka = torch.randn((B, S_, cfg.n_kv, cfg.head_dim), device=dev,
                     dtype=torch.bfloat16)
    va = torch.randn_like(ka)

    def flash_fb():
        xs = [x.detach().requires_grad_(True) for x in (qa, ka, va)]
        with torch.enable_grad():
            o = attn.flash_attention(*xs, True, 512)
            return torch.autograd.grad(o.float().sum(), xs)

    fig["flash_fwd_bwd_ms_per_layer"] = timed_ms(flash_fb, 3)
    fig["flash_share"] = (fig["flash_fwd_bwd_ms_per_layer"]
                          * cfg.num_layers / fig["warm_ms"])
    print(f"[families] olmoe: flash forward+backward alone "
          f"{fig['flash_fwd_bwd_ms_per_layer']:.2f} ms a layer x "
          f"{cfg.num_layers} = {fig['flash_share']:.1%} of the warm step")
    del qa, ka, va
    params = model.join(state["trainable"], frozen)
    del state, frozen
    torch.cuda.empty_cache()
    engine, _, sfig = serve("olmoe", model, params, 4, 6)
    fig.update(sfig)
    out["olmoe"] = fig
    del engine, params, model
    torch.cuda.empty_cache()
    # the kernel path's streams against the plain path's on a 2-layer
    # full-width f32 copy (TF32 off): K1's merge and K3 differ from the
    # plain versions only by f32 rounding
    cfg2 = cfgs["olmoe2"]
    model2 = build(cfg2, fpeft)
    params2 = model2.init(1, dev)
    streams = {}
    for backend in ("auto", "einsum"):
        m = build(cfg2, fpeft.replace(kernel_backend=backend))
        zero_counts()
        engine = Engine(m, params2, batch_slots=4, max_len=128, device=dev)
        sched = ContinuousScheduler(engine, page_size=16)
        reqs, arrivals = demo_trace(demo_prompts(cfg2, 4), 6, 16, 2.0)
        sched.serve(reqs, arrivals)
        sync()
        streams[backend] = ([r.out for r in reqs], launch_counts())
        del engine, sched
    if streams["auto"][0] != streams["einsum"][0]:
        raise PhaseError("families olmoe f32 2-layer: the kernel path's "
                         "streams differ from the plain path's")
    if streams["einsum"][1]["K1"] or streams["einsum"][1]["K3"] \
            or not streams["auto"][1]["K3"]:
        raise PhaseError(f"families olmoe f32: launches {streams}")
    print(f"[families] olmoe f32, 2 layers at full width: the kernel path's "
          f"{sum(len(s_) for s_ in streams['auto'][0])} tokens equal the "
          f"plain path's (K1 {streams['auto'][1]['K1']}, K3 "
          f"{streams['auto'][1]['K3']} launches against none)")
    del model2, params2
    torch.cuda.empty_cache()

    # ---- c. phi3.5-moe at full width, cut in depth ------------------------
    cfg = cfgs["phi"]
    model = build(cfg, fpeft)
    params = model.init(0, dev)
    n_base = describe("phi3.5-moe", cfg, params,
                      " (cut from 32: 84 GB in bf16 does not fit one card)")
    B, S_ = sizes["phi"]
    state, frozen, fig = train("phi35", model, params,
                               synthetic_batches(dev, cfg, B, S_, 3))
    fig["base_params"] = n_base
    params = model.join(state["trainable"], frozen)
    del state, frozen
    torch.cuda.empty_cache()
    engine, _, sfig = serve("phi35", model, params, 4, 6)
    fig.update(sfig)
    out["phi35"] = fig
    del engine, params, model
    torch.cuda.empty_cache()

    # ---- d. musicgen-medium at full size ----------------------------------
    cfg = cfgs["musicgen"]
    model = build(cfg, fpeft)
    params = model.init(0, dev)
    n_base = describe("musicgen", cfg, params)
    B, S_ = sizes["musicgen"]
    state, frozen, fig = train("musicgen", model, params,
                               synthetic_batches(dev, cfg, B, S_, 3))
    fig["base_params"] = n_base
    params = model.join(state["trainable"], frozen)
    del state, frozen
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    engine = Engine(model, params, batch_slots=2, max_len=64, device=dev)
    sync()
    merge_s = time.perf_counter() - t0
    prompts = demo_prompts(cfg, 2)
    t0 = time.perf_counter()
    gens = engine.generate(prompts, max_new=16)
    sync()
    gen_s = time.perf_counter() - t0
    got = launch_counts()
    if got["K1"] != 2 or got["K3"]:
        raise PhaseError(f"families musicgen serve: launches {got}; "
                         "expected K1 2 (the merge) and no K3 (lockstep)")
    if any(tuple(g.shape) != (16, cfg.n_codebooks) for g in gens) or any(
            int(g.min()) < 0 or int(g.max()) >= cfg.vocab for g in gens):
        raise PhaseError(f"families musicgen serve: streams "
                         f"{[tuple(g.shape) for g in gens]}")
    with torch.no_grad():
        logits = engine.model.forward(engine.params,
                                      {"tokens": prompts[1][None].to(dev)})
    if tuple(logits.shape) != (1, prompts[1].shape[0], cfg.n_codebooks,
                               cfg.vocab) or not torch.isfinite(
                                   logits.float()).all():
        raise PhaseError(f"families musicgen: logits "
                         f"{tuple(logits.shape)} not finite")
    out["launches"]["musicgen_serve"] = {"K1": got["K1"], "K3": 0}
    fig.update({"merge_s": merge_s, "generate_s": gen_s,
                "generate_tokens_per_s": 2 * 16 / gen_s})
    print(f"[families] musicgen serve: merge {merge_s:.3f} s (K1 "
          f"{got['K1']}), lockstep Engine.generate of 2 prompts -> "
          f"{[tuple(g.shape) for g in gens]} codebook streams in "
          f"{gen_s:.3f} s ({2 * 16 / gen_s:.1f} frames/s); first frames "
          f"{[g[0].tolist() for g in gens]}")
    out["musicgen"] = fig
    del engine, params, model, logits
    torch.cuda.empty_cache()

    # ---- e. qwen2-vl-72b at full width, cut in depth ----------------------
    # FourierFT on wq, wv and the MLP's up projection wi (8192 x 29568, past
    # one block's 29056 points: K1/K2 over a cluster of two blocks); the
    # gate projection wg is no adapter site (models/registry.py), in the
    # JAX package either
    cfg = cfgs["qwen2vl"]
    vsites = ("wq", "wv", "wi")
    model = build(cfg, fpeft.replace(target_modules=vsites))
    params = model.init(0, dev)
    n_base = describe("qwen2-vl", cfg, params,
                      " (cut from 80: the full model is 145 GB in bf16)")
    B, S_ = sizes["qwen2vl"]
    t = torch.arange(S_, device=dev, dtype=torch.int32)
    pos = torch.stack([t, t // 2, t % 7])[:, None, :].expand(3, B, S_)
    vbatches = []
    for i in range(2):
        g_ = torch.Generator(device=dev)
        g_.manual_seed(i)
        vbatches.append({
            "embeds": (torch.randn((B, S_, cfg.d_model), generator=g_,
                                   device=dev) * 0.5).to(torch.bfloat16),
            "positions": pos.contiguous(),
            "labels": torch.randint(0, cfg.vocab, (B, S_), generator=g_,
                                    device=dev, dtype=torch.int32)})
    state, frozen, fig = train("qwen2vl", model, params, vbatches,
                               sites=len(vsites), cluster_sites=1)
    fig["base_params"] = n_base
    params = model.join(state["trainable"], frozen)
    del state, frozen
    torch.cuda.empty_cache()
    zero_counts()
    merged_model, merged = merge_for_serving(model, params)
    k1, k1c = fdk.launches, fdk.cluster_launches
    with torch.no_grad():
        cache = merged_model.init_cache(B, S_ + 8, torch.bfloat16, dev)
        prompt = {k_: v_ for k_, v_ in vbatches[0].items()
                  if k_ != "labels"}
        nt, cache = merged_model.prefill(merged, cache, prompt)
        step = {"embeds": vbatches[1]["embeds"][:, :1],
                "positions": torch.full((3, B, 1), S_, dtype=torch.int32,
                                        device=dev)}
        t0 = time.perf_counter()
        logits, cache = merged_model.decode_logits(merged, cache, step)
        sync()
        dec_ms = (time.perf_counter() - t0) * 1e3
    if k1 != len(vsites) or k1c != 1 \
            or tuple(logits.shape) != (B, 1, cfg.vocab) \
            or not torch.isfinite(logits.float()).all() \
            or cache["pos"] != S_ + 1 or tuple(nt.shape) != (B,):
        raise PhaseError(f"families qwen2-vl decode: K1 {k1} ({k1c} over "
                         f"a cluster), logits {tuple(logits.shape)}, pos "
                         f"{cache['pos']}")
    out["launches"]["qwen2vl_merge"] = {"K1": k1, "K1c": k1c}
    fig.update({"decode_ms": dec_ms})
    print(f"[families] qwen2-vl: merged (K1 {k1}, {k1c} of them over a "
          f"cluster), prefill of {S_} embeddings with (3, B, S) M-RoPE "
          f"positions through flash, one decode_step {dec_ms:.2f} ms, "
          f"logits {tuple(logits.shape)} finite, next tokens {nt.tolist()}")
    out["qwen2vl"] = fig
    del merged_model, merged, cache, logits
    torch.cuda.empty_cache()
    # the dct method on the same sites and base: K4/K5 at wi over a
    # cluster in the train step, then K4's merge
    from repro_torch.core import peft as peft_mod
    dmodel = build(cfg, PEFTConfig(method="dct", n=1000, alpha=300.0,
                                   target_modules=vsites))
    gen_d = torch.Generator(device=dev)
    gen_d.manual_seed(0)
    dparams = {"base": params["base"], "peft": peft_mod.init_adapters(
        gen_d, dmodel.sites, dmodel.peft, dev)}
    del params, model
    state, frozen, dfig = train("qwen2vl_dct", dmodel, dparams, vbatches,
                                sites=len(vsites), cluster_sites=1)
    dparams = dmodel.join(state["trainable"], frozen)
    del state, frozen
    zero_counts()
    merged_model, merged = merge_for_serving(dmodel, dparams)
    sync()
    k4, k4c = ddk.launches, ddk.cluster_launches
    if k4 != len(vsites) or k4c != 1:
        raise PhaseError(f"families qwen2-vl dct merge: K4 {k4} ({k4c} over "
                         "a cluster); expected 3 (1)")
    out["launches"]["qwen2vl_dct_merge"] = {"K4": k4, "K4c": k4c}
    out["qwen2vl_dct"] = dfig
    print(f"[families] qwen2-vl dct: merged (K4 {k4}, {k4c} over a "
          "cluster)")
    del merged_model, merged, dparams, dmodel, vbatches
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[families] phase 18 took {out['phase_s']:.1f} s")
    print(json.dumps({"families": out}))
    return out


def ssd_scan_phase(dev, geometry, dtype, timed_ms, sync) -> dict:
    """Phase 19a (module docstring): the SSD scan alone at `geometry`
    (H, P, N, G, chunk, B, S), x, B and C in `dtype` (bf16, as the models
    run it, or f32; dt, A and D f32): the plain version (`ssd_chunked`)
    and the kernel (`mamba2.ssd_scan`'s route on the card) each held to
    the float64 oracle on the same values, timed, and their peak memory
    and bounds. Returns the readings (the kernel's under "kernel_*");
    raises PhaseError when a check fails."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import custom_ops
    from repro_torch.kernels import ssd_scan as ssk
    from repro_torch.models import mamba2
    H, P, N, G, chunk, B, S = geometry
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    tdt = getattr(torch, dtype)

    def randn(*shape, dt_=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt_)

    x = randn(B, S, H, P, dt_=tdt)
    B_, C_ = randn(B, S, G, N, dt_=tdt), randn(B, S, G, N, dt_=tdt)
    dt = F.softplus(randn(B, S, H)) * 0.1
    A = -torch.exp(randn(H) * 0.5)
    D = torch.ones(H, device=dev)
    cot = randn(B, S, H, P, dt_=tdt)
    ins = (x, dt, A, B_, C_, D)

    def scan(*xs):
        return mamba2.ssd_chunked(*xs, chunk=chunk)

    def kscan(*xs):
        return mamba2.ssd_scan(*xs, chunk=chunk)

    def grads(xs, fn=scan):
        xs = [t.detach().requires_grad_(True) for t in xs]
        with torch.enable_grad():
            y, _ = fn(*xs)
            return torch.autograd.grad((y * cot.to(y.dtype)).sum(),
                                       [xs[i] for i in (0, 1, 3, 4)])

    def rel(a, b):
        """max |a - b| over the largest |b| (each tensor against its own
        size); a bf16 `a` is first allowed the half ulp of its own
        rounding, 2^-8 of |b| (the card tests' allowance)."""
        err = (a.double() - b).abs()
        if a.dtype == torch.bfloat16:
            err = (err - 2.0 ** -8 * b.abs()).clamp_min(0.0)
        return float(err.max() / b.abs().max())

    with torch.no_grad():
        y64, f64 = mamba2.ssd_recurrent_oracle(*(t.double() for t in ins))
        y32, f32 = scan(*ins)
        # the control: the f32 oracle on the same values
        yo, fo = mamba2.ssd_recurrent_oracle(*(t.float() for t in ins))
    rec = {"y": rel(y32, y64), "state": rel(f32, f64),
           "control_y": rel(yo, y64), "control_state": rel(fo, f64),
           "max_y": float(y64.abs().max()),
           "max_state": float(f64.abs().max())}
    g32 = grads(ins)
    g64 = grads([t.double() for t in ins])
    rec["grad"] = [rel(a, b) for a, b in zip(g32, g64)]
    k0 = (ssk.launches, ssk.bwd_launches)
    with torch.no_grad():
        yk, fk = kscan(*ins)
    gk = grads(ins, kscan)
    sync()
    if (ssk.launches - k0[0], ssk.bwd_launches - k0[1]) != (2, 1):
        raise PhaseError(f"ssm scan H {H} {dtype}: the route launched the "
                         "kernel "
                         f"{ssk.launches - k0[0]} / {ssk.bwd_launches - k0[1]}"
                         " times for 2 forwards and a backward")
    rec["kernel_y"], rec["kernel_state"] = rel(yk, y64), rel(fk, f64)
    rec["kernel_grad"] = [rel(a, b) for a, b in zip(gk, g64)]
    del y64, f64, yo, fo, g32, g64, yk, fk, gk
    # the CPU suite holds the scan to atol 1e-4 on tensors whose largest
    # |value| is of order 1 (tests/test_torch_ssm.py); here each tensor is
    # held to 1e-4 of its own largest |value|
    limit = 1e-4
    what = (("" if dtype == "float32" else "not held in bf16: ")
            + f"y {rec['y']:.3e}, final state {rec['state']:.3e} of their "
            f"largest |value| ({rec['max_y']:.1f}, {rec['max_state']:.1f}; "
            f"limit {limit:g}; the f32 oracle's own reading "
            f"{rec['control_y']:.3e}, {rec['control_state']:.3e}), "
            f"dx/ddt/dB/dC against float64 autograd "
            f"{[f'{g:.2e}' for g in rec['grad']]}")
    kwhat = (f"kernel: y {rec['kernel_y']:.3e}, final state "
             f"{rec['kernel_state']:.3e}, dx/ddt/dB/dC "
             f"{[f'{g:.2e}' for g in rec['kernel_grad']]}")
    # the plain version is held in f32; on bf16 inputs its autograd rounds
    # x's two gradient terms (the scan's and D·x's) to bf16 before it sums
    # them, so dx reads near 1e-3 there: printed, not held
    if dtype == "float32" and max(rec["y"], rec["state"], *rec["grad"]) \
            > limit:
        raise PhaseError(f"ssm scan H {H} P {P} N {N} S {S} {dtype}: "
                         f"chunked against the float64 oracle: {what}")
    if max(rec["kernel_y"], rec["kernel_state"], *rec["kernel_grad"]) \
            > limit:
        raise PhaseError(f"ssm scan H {H} P {P} N {N} S {S} {dtype}: the "
                         f"kernel against the float64 oracle (limit "
                         f"{limit:g}): {kwhat}")
    sync()
    before = torch.cuda.memory_allocated()
    for label, fn in (("fwd", lambda: scan(*ins)),
                      ("fwd_bwd", lambda: grads(ins)),
                      ("kernel_fwd", lambda: kscan(*ins)),
                      ("kernel_fwd_bwd", lambda: grads(ins, kscan))):
        torch.cuda.reset_peak_memory_stats()
        with torch.set_grad_enabled(label.endswith("fwd_bwd")):
            fn()
        sync()
        rec[f"{label}_peak_gib"] = (torch.cuda.max_memory_allocated()
                                    - before) / 2 ** 30
        rec[f"{label}_ms"] = timed_ms(fn, 10 if label.startswith("kernel")
                                      else 3)
    # the plain version's bound: the chunked algorithm's operations per
    # (batch, chunk) as it computes them, every (Q, Q) square whole: C·Bᵀ
    # scores (2Q²NG), the decay mask's exp and product (2HQ²), the
    # diagonal output (2HQ²P), the chunk states and the off-diagonal
    # output (2HQPN each). The kernel's: the causal work of its own
    # decomposition, the op's count (`custom_ops._ssd_ops`, the
    # benchmark's `ssd_ops`) at the kernel's chunk `ssd_scan.tiling(S)`
    # (64 rows): 9.46 GF a layer forward at zamba2-7b-instruct's 4096
    # tokens, against 23.05 GF of the plain count and 15.2 GF of the
    # causal count at the model's chunk of 256. The backward takes twice
    # the forward's operations. Bytes: each input read and each output
    # written once, plus the cotangent and the four gradients for
    # forward+backward.
    Q, nc = chunk, S // chunk
    flops = B * nc * (2 * Q * Q * N * G + 2 * H * Q * Q
                      + 2 * H * Q * Q * P + 4 * H * Q * P * N)
    kflops = custom_ops._ssd_ops(x, B_, ssk.tiling(S)[0])
    e = x.element_size()
    in_bytes = (e * (B * S * H * P + 2 * B * S * G * N)
                + 4.0 * (B * S * H + 2 * H))
    out_bytes = e * B * S * H * P + 4.0 * B * H * P * N
    fb_bytes = 2 * in_bytes + out_bytes + e * B * S * H * P
    rec["bound_ms"], rec["bound_by"] = bound(flops, in_bytes + out_bytes,
                                             "float32")
    rec["fwd_bwd_bound_ms"], rec["fwd_bwd_bound_by"] = bound(
        3 * flops, fb_bytes, "float32")
    rec["kernel_bound_ms"], rec["kernel_bound_by"] = bound(
        kflops, in_bytes + out_bytes, "float32")
    rec["kernel_fwd_bwd_bound_ms"], _ = bound(3 * kflops, fb_bytes,
                                              "float32")
    rec["limit"] = limit
    print(f"[ssm] scan B {B} S {S} H {H} P {P} N {N} G {G} chunk {chunk}, "
          f"{dtype}: {what} | forward {rec['fwd_ms']:.3f} ms (bound "
          f"{rec['bound_ms']:.4f} ms, {rec['bound_by']}; "
          f"{rec['fwd_ms'] / rec['bound_ms']:.1f}x), forward+backward "
          f"{rec['fwd_bwd_ms']:.3f} ms (bound {rec['fwd_bwd_bound_ms']:.4f} "
          f"ms, {rec['fwd_bwd_ms'] / rec['fwd_bwd_bound_ms']:.1f}x) | peak "
          f"above the inputs: forward {rec['fwd_peak_gib']:.3f} GiB, "
          f"forward+backward {rec['fwd_bwd_peak_gib']:.3f} GiB")
    print(f"[ssm] scan kernel H {H} N {N} G {G} S {S} {dtype}: {kwhat} | "
          f"forward {rec['kernel_fwd_ms']:.3f} ms (bound "
          f"{rec['kernel_bound_ms']:.4f} ms, {rec['kernel_bound_by']}, its "
          f"causal work at chunks of {ssk.tiling(S)[0]}; "
          f"{rec['kernel_fwd_ms'] / rec['kernel_bound_ms']:.1f}x; "
          f"{rec['fwd_ms'] / rec['kernel_fwd_ms']:.1f}x faster than plain), "
          f"forward+backward {rec['kernel_fwd_bwd_ms']:.3f} ms (bound "
          f"{rec['kernel_fwd_bwd_bound_ms']:.4f} ms; "
          f"{rec['kernel_fwd_bwd_ms'] / rec['kernel_fwd_bwd_bound_ms']:.1f}"
          f"x, {rec['fwd_bwd_ms'] / rec['kernel_fwd_bwd_ms']:.1f}x) | peak "
          f"above the inputs {rec['kernel_fwd_peak_gib']:.3f} / "
          f"{rec['kernel_fwd_bwd_peak_gib']:.3f} GiB")
    del x, B_, C_, dt, A, D, cot, ins
    torch.cuda.empty_cache()
    return rec


def ssm_phase(dev, cfgs, sizes, timed_ms, sync) -> dict:
    """Phase 19 (module docstring) on `dev`. `cfgs` maps each part to its
    model config ("mamba", "mamba_f32" its 2-layer f32 copy, "zamba",
    "zamba_f32" its f32 copy with a full group and the tail); `sizes`
    holds 19a's scan geometry ("scan": (H, P, N, G, chunk, B, S)), each
    model's training (B, S) ("mamba", "zamba") and the decode step's
    max_len ("decode_len"). `timed_ms(fn, iters)` times on the card; `sync`
    waits for it. Returns the launch counts of each part's run by kernel
    and the parts' figures; raises PhaseError when a check fails."""
    import torch
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.launch.serve import demo_prompts
    from repro_torch.models import attention as attn
    from repro_torch.models import build, mamba2, zamba2
    from repro_torch.serve import ContinuousScheduler, Engine
    from repro_torch.serve import merge_for_serving
    from repro_torch.tree import tree_leaves
    fpeft = PEFTConfig(method="fourierft", n=1000, alpha=300.0)
    out = {"launches": {}}
    t_phase = time.perf_counter()
    gib = 2 ** 30

    # ---- a. the SSD scan alone, bf16 (as the models run it) and f32 ----
    for key in ("scan", "scan_pack4k"):
        out[key] = {dtype: ssd_scan_phase(dev, sizes[key], dtype, timed_ms,
                                          sync)
                    for dtype in ("bfloat16", "float32")}

    def describe(name, cfg, params, cut=""):
        d_inner, H, P, G = mamba2.dims(cfg)
        n_base = sum(t.numel() for t in tree_leaves(params["base"]))
        extra = (f", one shared block (heads {cfg.n_heads}/{cfg.n_kv} of "
                 f"{cfg.head_dim}, d_ff {cfg.d_ff}) applied "
                 f"{zamba2.n_apps(cfg)} times" if cfg.zamba else "")
        print(f"[ssm] {name}: {cfg.name}, {cfg.num_layers} layers{cut}, "
              f"d_model {cfg.d_model}, d_inner {d_inner} ({H} heads of {P}, "
              f"state {cfg.ssm.state}){extra}, vocab {cfg.vocab}, "
              f"{cfg.dtype}; {n_base:,} base parameters, "
              f"{torch.cuda.memory_allocated() / gib:.2f} GiB held")
        return n_base

    def serve(name, model, params):
        """Engine (the merge: K1 on the layer sites) and a lockstep
        generate of 4 demo prompts x 16 tokens through the recurrent
        prefill (no K3: no paged cache); the continuous scheduler refuses
        the family. Returns (engine, figures)."""
        zero_counts()
        t0 = time.perf_counter()
        engine = Engine(model, params, batch_slots=4, max_len=64,
                        device=dev)
        sync()
        merge_s = time.perf_counter() - t0
        k1 = fdk.launches
        prompts = demo_prompts(model.cfg, 4)
        t0 = time.perf_counter()
        gens = engine.generate(prompts, max_new=16)
        sync()
        gen_s = time.perf_counter() - t0
        got = launch_counts()
        if k1 != 2 or got["K1"] != 2 or got["K3"]:
            raise PhaseError(f"ssm {name} serve: launches {got} (K1 {k1} "
                             "by the merge); expected K1 2 and no K3")
        if any(tuple(g.shape) != (16,) for g in gens) or any(
                int(g.min()) < 0 or int(g.max()) >= model.cfg.vocab
                for g in gens):
            raise PhaseError(f"ssm {name} serve: streams "
                             f"{[tuple(g.shape) for g in gens]}")
        try:
            ContinuousScheduler(engine)
        except NotImplementedError:
            pass
        else:
            raise PhaseError(f"ssm {name}: ContinuousScheduler accepted a "
                             "recurrent family")
        out["launches"][name + "_merge"] = {"K1": k1}
        n_prompt = sum(int(p.shape[0]) for p in prompts)
        print(f"[ssm] {name} serve: merge {merge_s:.3f} s (K1 {k1}), "
              f"lockstep Engine.generate of 4 prompts ({n_prompt} prompt "
              f"tokens, prefilled token by token) x 16 new tokens in "
              f"{gen_s:.3f} s ({4 * 16 / gen_s:.1f} tokens/s), K3 "
              f"{got['K3']}; first tokens {[int(g[0]) for g in gens]}; "
              "ContinuousScheduler refuses the family")
        return engine, {"merge_s": merge_s, "generate_s": gen_s,
                        "generate_tokens_per_s": 4 * 16 / gen_s}

    def kernel_vs_plain(name, cfg, peft, keys):
        """On a full-width f32 copy (TF32 off): the merge by K1 and by the
        einsum path, the merged `keys` held by `merged_f32_close`, and
        lockstep streams of the two paths equal. Returns the number of
        tokens."""
        params = build(cfg, peft).init(1, dev)
        streams, merged_w, launches = {}, {}, {}
        for backend in ("auto", "einsum"):
            m = build(cfg, peft.replace(kernel_backend=backend))
            zero_counts()
            mm, mp = merge_for_serving(m, params)
            merged_w[backend] = {k: mp["base"]["layers"][k] for k in keys}
            engine = Engine(mm, mp, batch_slots=4, max_len=64, device=dev)
            gens = engine.generate(demo_prompts(cfg, 4), max_new=16)
            sync()
            streams[backend] = [g.tolist() for g in gens]
            launches[backend] = launch_counts()
            del engine, mm, mp
        shares = {}
        for k in keys:
            ok, shares[k] = merged_f32_close(
                params["base"]["layers"][k], merged_w["auto"][k],
                merged_w["einsum"][k])
            if not ok:
                raise PhaseError(f"ssm {name} f32: merged {k} of K1 and of "
                                 "the plain path differ by "
                                 f"{shares[k]:.3f} of their limit (one f32 "
                                 f"ulp + {REL_TO_PLAIN} of max |ΔW|)")
        if streams["auto"] != streams["einsum"]:
            raise PhaseError(f"ssm {name} f32 {cfg.num_layers} layers: the "
                             "kernel path's streams differ from the plain "
                             "path's")
        if launches["auto"]["K1"] != 2 or launches["einsum"]["K1"] \
                or launches["auto"]["K3"]:
            raise PhaseError(f"ssm {name} f32: launches {launches}")
        n_tok = sum(len(s_) for s_ in streams["auto"])
        print(f"[ssm] {name} f32, {cfg.num_layers} layers at full width: "
              f"merged {list(keys)} of K1 against the plain path's at "
              f"{', '.join(f'{v:.3f}' for v in shares.values())} of the "
              f"limit (one f32 ulp + {REL_TO_PLAIN} of the layer's max "
              f"|ΔW|), and the kernel path's {n_tok} tokens equal the "
              f"plain path's (K1 {launches['auto']['K1']} launches against "
              "none)")
        del params, merged_w
        torch.cuda.empty_cache()
        return n_tok

    # ---- b. mamba2-2.7b at full size ----------------------------------------
    cfg = cfgs["mamba"]
    model = build(cfg, fpeft, remat="full")
    if model.peft.target_modules != ("wx", "wo_ssm"):
        raise PhaseError(f"ssm mamba2: default targets resolved to "
                         f"{model.peft.target_modules}")
    params = model.init(0, dev)
    n_base = describe("mamba2", cfg, params)
    B, S_ = sizes["mamba"]
    # remat="full" checkpoints each layer: its scan runs forward, again in
    # the recompute, and backward
    state, frozen, fig, got = counted_train(
        "ssm", "mamba2", model, params,
        synthetic_batches(dev, cfg, B, S_, TRAIN_STEPS_19), 0, sync,
        scan_calls=(2 * cfg.num_layers, cfg.num_layers))
    out["launches"]["ssm_train"] = got
    fig["base_params"] = n_base
    # the scan's share of the warm step: its forward and its
    # forward+backward alone at a layer's shapes (bf16 activations, f32
    # dt), times the layers; remat="full" runs each layer's forward twice
    d_inner, H, P, G = mamba2.dims(cfg)
    N = cfg.ssm.state
    xs = [torch.randn(shape, device=dev, dtype=dtype) for shape, dtype in (
        ((B, S_, H, P), torch.bfloat16), ((B, S_, H), torch.float32),
        ((H,), torch.float32), ((B, S_, G, N), torch.bfloat16),
        ((B, S_, G, N), torch.bfloat16), ((H,), torch.float32))]
    xs[1] = torch.nn.functional.softplus(xs[1]) * 0.1
    xs[2] = -torch.exp(xs[2] * 0.5)

    def scan_fb():
        ts_ = [t.detach().requires_grad_(True) for t in xs]
        with torch.enable_grad():
            y, _ = mamba2.ssd_scan(*ts_, chunk=min(cfg.ssm.chunk, S_))
            return torch.autograd.grad(y.float().sum(), ts_[:2])

    with torch.no_grad():
        fig["scan_fwd_ms_per_layer"] = timed_ms(
            lambda: mamba2.ssd_scan(*xs, chunk=min(cfg.ssm.chunk, S_)), 3)
    fig["scan_fwd_bwd_ms_per_layer"] = timed_ms(scan_fb, 3)
    fig["scan_share"] = ((fig["scan_fwd_ms_per_layer"]
                          + fig["scan_fwd_bwd_ms_per_layer"])
                         * cfg.num_layers / fig["warm_ms"])
    print(f"[ssm] mamba2: the scan alone {fig['scan_fwd_ms_per_layer']:.2f} "
          f"ms forward, {fig['scan_fwd_bwd_ms_per_layer']:.2f} ms "
          f"forward+backward a layer; (forward + forward+backward) x "
          f"{cfg.num_layers} = {fig['scan_share']:.1%} of the warm step")
    del xs
    params = model.join(state["trainable"], frozen)
    del state, frozen
    torch.cuda.empty_cache()
    engine, sfig = serve("ssm", model, params)
    fig.update(sfig)
    out["mamba2"] = fig
    del engine, params, model
    torch.cuda.empty_cache()
    kernel_vs_plain("mamba2", cfgs["mamba_f32"], fpeft, ("wx", "wo_ssm"))

    # ---- c. zamba2-7b at full width -----------------------------------------
    cfg = cfgs["zamba"]
    zpeft = fpeft.replace(target_modules=("wq", "wv", "wx", "wo_ssm"))
    model = build(cfg, zpeft, remat="full")
    params = model.init(0, dev)
    n_base = describe("zamba2", cfg, params)
    n_full, _ = zamba2._split(cfg)
    apps = zamba2.n_apps(cfg)
    B, S_ = sizes["zamba"]
    steps = TRAIN_STEPS_19
    # flash once per application a step, and once more for each checkpointed
    # (full) group when the backward recomputes it; the scan once a layer,
    # again for each layer of a full group, and once a layer backward
    state, frozen, fig, got = counted_train(
        "ssm", "zamba2", model, params,
        synthetic_batches(dev, cfg, B, S_, steps),
        steps * (apps + n_full), sync,
        scan_calls=(cfg.num_layers + n_full * cfg.zamba.shared_every,
                    cfg.num_layers))
    out["launches"]["hybrid_train"] = got
    fig["base_params"] = n_base
    params = model.join(state["trainable"], frozen)
    del state, frozen
    torch.cuda.empty_cache()
    engine, sfig = serve("hybrid", model, params)
    fig.update(sfig)
    left = set(engine.params["peft"])
    if engine.model.peft.method != "fourierft" \
            or left != {"shared/wq", "shared/wv"}:
        raise PhaseError(f"ssm zamba2 merge: leftover {sorted(left)} under "
                         f"{engine.model.peft.method!r}; expected the shared "
                         "sites under fourierft")
    print(f"[ssm] zamba2 merge: layers/wx and layers/wo_ssm folded (K1 2), "
          f"{sorted(left)} left factored under "
          f"{engine.model.peft.method}")
    # one decode step alone at max_len T, every application's cache full
    # to pos T - 1 (random rows), the shared q/v applied factored
    T = sizes["decode_len"]
    dt_ = torch.bfloat16
    cache = engine.model.init_cache(4, T, dt_, dev)
    for key in ("attn_k", "attn_v"):
        cache[key].normal_()
    cache["pos"] = T - 1
    tok = {"tokens": torch.zeros((4, 1), dtype=torch.int32, device=dev)}
    zero_counts()

    def step():
        with torch.no_grad():
            return engine.model.decode_step(engine.params, dict(cache), tok)

    walls = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        step()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    dev_ms, kernels_per, top = device_ms(step, 3)
    q = torch.randn((4, 1, cfg.n_heads, cfg.head_dim), device=dev, dtype=dt_)

    def attentions():
        for a in range(apps):
            attn.direct_attention(q, cache["attn_k"][a], cache["attn_v"][a],
                                  causal=False, kv_len=T)

    att_ms = device_ms(attentions, 3)[0]
    got = launch_counts()
    if got["K1"] or got["K3"]:
        raise PhaseError(f"ssm zamba2 decode: launches {got}")
    fig.update({"decode_wall_ms": sorted(walls)[2], "decode_device_ms":
                dev_ms, "decode_kernels": kernels_per,
                "decode_attention_device_ms": att_ms,
                "decode_attention_share": (att_ms / dev_ms if att_ms and
                                           dev_ms else None)})
    share = (f"{fig['decode_attention_share']:.1%}"
             if fig["decode_attention_share"] is not None else
             "not measured")
    dev_txt = (f"{dev_ms:.2f} ms device time ({kernels_per:.0f} kernels; "
               f"top {[(k_, round(t_, 3)) for k_, t_ in top]})"
               if dev_ms is not None else "device time not measured")
    print(f"[ssm] zamba2 decode step, 4 sequences at pos {T - 1} of max_len "
          f"{T}: {fig['decode_wall_ms']:.2f} ms wall (median of 5), "
          f"{dev_txt}; the {apps} direct attentions over the "
          f"per-application caches {share} of the device time")
    out["zamba2"] = fig
    del engine, params, model, cache, q
    torch.cuda.empty_cache()
    kernel_vs_plain("zamba2", cfgs["zamba_f32"], zpeft, ("wx", "wo_ssm"))
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[ssm] phase 19 took {out['phase_s']:.1f} s")
    print(json.dumps({"ssm": out}))
    return out


def fft_edges():
    """(limit, d1, d2, n) of the FFT-structured kernels' edges: d2 the
    largest width <= MAX_D2 whose odd prime factors are <= MAX_RADIX, d1 =
    MAX_D1, n = MAX_N, each with the other dims small."""
    from repro_torch.kernels import fft_plan
    d2 = fft_plan.MAX_D2
    while True:
        try:
            fft_plan.factor(d2)
            break
        except ValueError:
            d2 -= 1
    return (("d2", 64, d2, 64), ("d1", fft_plan.MAX_D1, 64, 64),
            ("n", 256, 256, fft_plan.MAX_N))


def analysis_phase(dev, cfgs, sizes, sync, set_sync_debug, launcher_argv
                   ) -> dict:
    """Phase 20 (module docstring) on `dev`. `cfgs` holds the train model's
    config ("train", yi-6b at SLICE_LAYERS) and the serving one's
    ("serve", all 32 layers); `sizes` the train batch ("train": (B, S,
    steps)) and the serving geometry ("serve": (slots, max_len, page,
    requests, max_new, arrival gap)); `sync` waits for the card;
    `set_sync_debug(mode)` is torch.cuda.set_sync_debug_mode;
    `launcher_argv` the argv of 20c's `launch.serve --analyze`. Returns
    the main path's launches and the lint's figures; raises PhaseError
    when a check fails."""
    import warnings

    import torch
    from repro_torch.analysis import ast_lint, graphs, kernel_audit, report
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.core.fourierft import sample_entries
    from repro_torch.kernels import api
    from repro_torch.kernels import dct_deltaw as ddk
    from repro_torch.kernels import fft_plan
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.launch.serve import demo_prompts, demo_trace
    from repro_torch.models import build
    from repro_torch.serve import Engine
    t_phase = time.perf_counter()
    out = {"launches": {}}
    baseline = report.load_baseline()
    findings = ast_lint.lint_package()

    # ---- a. the audit on the card, and each kernel at its edges -------------
    optin = kernel_audit.device_smem_optin(dev)
    audit = kernel_audit.run() + kernel_audit.audit_device(dev)
    findings += audit
    print(f"[analysis] kernel audit: {len(audit)} finding(s), shared memory "
          f"a block may request on this card {optin} B (fft_plan "
          f"{fft_plan.SMEM_BYTES}, K3 {pak.CAPS['smem_bytes']}); derived "
          f"fourier {kernel_audit.derived_fft_limits(fft_plan.FOURIER_CAPS)}, "
          f"K3 {kernel_audit.derived_k3(pak.CAPS)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    alpha = 300.0
    for limit, d1, d2, n in fft_edges():
        entries = sample_entries(d1, d2, n, seed=7).to(dev)
        u, v = padded_entries(entries, n, fdk.NC)
        c = torch.zeros((1, u.shape[0]), dtype=torch.float32, device=dev)
        c[:, :n] = torch.randn((1, n), generator=gen, device=dev)
        g = torch.randn((1, d1, d2), generator=gen, device=dev)
        for tag, mod in (("K1", fdk), ("K4", ddk)):
            got = mod.deltaw(c, u, v, d1, d2, alpha)
            again = mod.deltaw(c, u, v, d1, d2, alpha)
            ref = mod.deltaw_reference(c, u, v, d1, d2, alpha)
            sync()
            diff = (got - ref).abs()
            err, scale = float(diff.max()), float(ref.abs().max())
            bad = (err > min(2e-4, REL_TO_PLAIN * scale)) if tag == "K1" \
                else bool((diff > 2e-5 + 1e-5 * ref.abs()).any())
            if bad or not torch.isfinite(got).all():
                raise PhaseError(f"analysis: {tag} at the {limit} edge "
                                 f"{d1}x{d2} n={n}: max |kernel - plain| "
                                 f"{err:.3e} (max |plain| {scale:.3e})")
            if not torch.equal(got, again):
                raise PhaseError(f"analysis: {tag} at the {limit} edge: two "
                                 "launches gave different bits")
            print(f"[analysis] {tag} at the {limit} edge {d1}x{d2} n={n}: "
                  f"max_abs_err {err:.3e} ({err / max(scale, 1e-30):.2e} of "
                  "max |plain|), bit-identical on a second launch")
        for tag, mod in (("K2", fdk), ("K5", ddk)):
            got = mod.dc(g, u, v, d1, d2, alpha)
            again = mod.dc(g, u, v, d1, d2, alpha)
            ref = mod.dc_reference(g, u, v, d1, d2, alpha)
            sync()
            diff = (got - ref).abs()
            err, scale = float(diff.max()), float(ref.abs().max())
            bad = (bool((diff > 2e-3 + 1e-4 * ref.abs()).any())
                   or err > REL_TO_PLAIN * scale) if tag == "K2" \
                else bool((diff > 1e-4 + 1e-3 * ref.abs()).any())
            if bad or not torch.isfinite(got).all():
                raise PhaseError(f"analysis: {tag} at the {limit} edge "
                                 f"{d1}x{d2} n={n}: max |kernel - plain| "
                                 f"{err:.3e} (max |plain| {scale:.3e})")
            if not torch.equal(got, again):
                raise PhaseError(f"analysis: {tag} at the {limit} edge: two "
                                 "launches gave different bits")
            print(f"[analysis] {tag} at the {limit} edge {d1}x{d2} n={n}: "
                  f"max_abs_err {err:.3e} ({err / max(scale, 1e-30):.2e} of "
                  "max |plain|), bit-identical on a second launch")
        del g, c, got, again, ref, diff
    # K3 at the widest head class, ragged kv_len, G = 4
    B, H, K, dh, ps, pps = 2, 8, 2, pak.MAX_HEAD_DIM, 16, 8
    bt = torch.arange(B * pps, dtype=torch.int32,
                      device=dev).reshape(B, pps) + 1
    kv_len = torch.tensor([pps * ps - 3, 37], dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((B, 1, H, dh), generator=gen, device=dev).to(dtype)
        kp = torch.randn((B * pps + 1, ps, K, dh), generator=gen,
                         device=dev).to(dtype)
        vp = torch.randn((B * pps + 1, ps, K, dh), generator=gen,
                         device=dev).to(dtype)
        got = pak.paged_attention(q, kp, vp, bt, kv_len)
        again = pak.paged_attention(q, kp, vp, bt, kv_len)
        ref = pak.paged_attention_reference(q.float(), kp.float(),
                                            vp.float(), bt, kv_len)
        sync()
        share = float(((got.float() - ref).abs()
                       / pak.agreement_limit(ref, dtype)).max())
        if share > 1.0 or not torch.isfinite(got.float()).all():
            raise PhaseError(f"analysis: K3 at head_dim {dh} {dtype}: "
                             f"{share:.3f} of agreement_limit")
        if not torch.equal(got, again):
            raise PhaseError(f"analysis: K3 at head_dim {dh} {dtype}: two "
                             "launches gave different bits")
        print(f"[analysis] K3 at head_dim {dh}, {dtype}: {share:.3f} of "
              "agreement_limit, bit-identical on a second launch")
    # one shape past each limit is refused, naming the limit: the audit's
    # probes, just past the declared limits and past the derived ones
    probes = sorted({p for lim in (
        kernel_audit.declared_fft_limits(),
        kernel_audit.derived_fft_limits(fft_plan.FOURIER_CAPS))
        for p in kernel_audit.fft_probes(lim)})
    past = [(method, d1, d2_, n, str(getattr(fft_plan, name)))
            for method in ("fourierft", "dct")
            for name, d1, d2_, n in probes]
    d2 = min(p[2] for p in probes if p[0] == "MAX_D2")
    for method, d1, d2_, n, name in past:
        try:
            api.resolve_op("deltaw", method, PEFTConfig(method=method, n=n),
                           d1, d2_, device="cuda")
        except api.KernelUnavailableError as e:
            if name not in str(e):
                raise PhaseError(f"analysis: {method} {d1}x{d2_} n={n} "
                                 f"refused without naming {name}: {e}")
        else:
            raise PhaseError(f"analysis: {method} {d1}x{d2_} n={n} was "
                             "not refused")
    try:
        api.resolve_op("paged_attention", pak.OWNER, None, K,
                       pak.MAX_HEAD_DIM + 1, device="cuda",
                       dtype=torch.bfloat16)
    except api.KernelUnavailableError as e:
        if str(pak.MAX_HEAD_DIM) not in str(e):
            raise PhaseError(f"analysis: K3 refused head_dim "
                             f"{pak.MAX_HEAD_DIM + 1} without naming the "
                             f"limit: {e}")
    else:
        raise PhaseError("analysis: K3 took head_dim past MAX_HEAD_DIM")
    if dev.type == "cuda":
        # the wrappers refuse too, before any launch
        e16 = torch.zeros((2, 16), dtype=torch.int32, device=dev)
        for call, name in (
                (lambda: fdk.deltaw(torch.zeros((1, 16), device=dev),
                                    e16[0], e16[1], 64, d2, alpha),
                 str(fft_plan.MAX_D2)),
                (lambda: pak.paged_attention(
                    torch.zeros((1, 1, 2, 264), device=dev),
                    torch.zeros((2, 16, 2, 264), device=dev),
                    torch.zeros((2, 16, 2, 264), device=dev),
                    torch.zeros((1, 1), dtype=torch.int32, device=dev),
                    torch.ones((1,), dtype=torch.int32, device=dev)),
                 str(pak.MAX_HEAD_DIM))):
            try:
                call()
            except ValueError as e:
                if name not in str(e):
                    raise PhaseError(f"analysis: a wrapper refused without "
                                     f"naming {name}: {e}")
            else:
                raise PhaseError(f"analysis: a wrapper launched past {name}")
    print(f"[analysis] {len(past) + 1} shapes past the limits refused at "
          "resolution, each naming its limit")

    # ---- b. the dispatch lint at full width -----------------------------------
    peft = PEFTConfig(method="fourierft", n=1000, alpha=300.0)
    tcfg_model = build(cfgs["train"], peft)
    tparams = tcfg_model.init(0, dev)
    B_, S_, steps = sizes["train"]
    bs = synthetic_batches(dev, cfgs["train"], B_, S_, steps)
    zero_counts()
    tf, trec = graphs.lint_train(tcfg_model, tparams, bs, dev)
    sync()
    tl = launch_counts()
    if tl["K1"] != 2 * steps or tl["K2"] != 2 * steps:
        raise PhaseError(f"analysis: the linted train step launched K1 "
                         f"{tl['K1']} and K2 {tl['K2']} times in {steps} "
                         "steps, expected 2 a step each")
    ts = trec.summary("train_step")
    print(f"[analysis] train step ({cfgs['train'].name}, "
          f"{cfgs['train'].num_layers} layers, B {B_} x S {S_}): "
          f"{ts['ops_per_region']:.0f} aten ops and "
          f"{ts['transfers_per_region']:g} host transfers a step "
          f"{json.dumps(ts['transfers'])}; K1 {tl['K1']}, K2 {tl['K2']}")
    findings += tf
    del tcfg_model, tparams, bs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    slots, max_len, page, n_req, max_new, gap = sizes["serve"]
    smodel = build(cfgs["serve"], peft)
    sparams = smodel.init(0, dev)
    zero_counts()
    engine = Engine(smodel, sparams, batch_slots=slots, max_len=max_len,
                    device=dev)
    prompts = demo_prompts(cfgs["serve"], slots)
    reqs, arrivals = demo_trace(prompts, n_req, max_new, gap)
    caught_at = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        set_sync_debug("warn")
        try:
            sf, srec, sched = graphs.lint_serve(
                engine, reqs, "serve/paged", dev, arrivals=arrivals,
                page_size=page,
                on_round=lambda evs: caught_at.append(sum(
                    str(w.message).startswith(SYNC_WARNING)
                    for w in caught)))
        finally:
            set_sync_debug("default")
    sync()
    sl = launch_counts()
    steps_s = sched.metrics.steps
    layers = cfgs["serve"].num_layers
    if sl["K3"] != steps_s * layers or sl["K1"] < 1:
        raise PhaseError(f"analysis: the linted replay launched K3 "
                         f"{sl['K3']} times ({steps_s} decode steps x "
                         f"{layers} layers expected), K1 {sl['K1']}")
    for i, r in enumerate(reqs):
        if r.out is None or len(r.out) != r.max_new:
            raise PhaseError(f"analysis: request {i} emitted {r.out!r}")
    lint_rounds = [r.n_transfers for r in srec.regions]
    debug_rounds = [b - a for a, b in zip([0] + caught_at[:-1], caught_at)]
    ds, adm = srec.summary("serve/paged/decode"), \
        srec.summary("serve/paged/admit")
    print(f"[analysis] decode replay ({cfgs['serve'].name}, {layers} layers, "
          f"{slots} slots, {len(reqs)} requests, {steps_s} decode steps): "
          f"{ds['regions']} decode rounds, {ds['ops_per_region']:.0f} aten "
          f"ops and {ds['transfers_per_region']:g} host transfers a round "
          f"{json.dumps(ds['transfers'])}; {adm['regions']} admitting "
          f"rounds, {adm['transfers_per_region']:g} a round "
          f"{json.dumps(adm['transfers'])}; K1 {sl['K1']}, K3 {sl['K3']}")
    print(f"[analysis] synchronizations a round, lint / "
          f"set_sync_debug_mode: {lint_rounds} / {debug_rounds}")
    if dev.type == "cuda" and lint_rounds != debug_rounds:
        raise PhaseError("analysis: the lint and set_sync_debug_mode('warn') "
                         "count different synchronizations")
    sigs = sched.compiled_signatures()
    print(f"[analysis] compiled signatures {sigs}, bounds "
          f"{sched.expected_compile_bounds()}")
    findings += sf
    out["launches"]["analysis"] = {"K1": tl["K1"] + sl["K1"],
                                   "K2": tl["K2"], "K3": sl["K3"]}
    out["train_transfers_per_step"] = ts["transfers_per_region"]
    out["decode_transfers_per_step"] = ds["transfers_per_region"]
    out["sync_debug_rounds"] = debug_rounds
    del engine, sched, smodel, sparams
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(report.render(findings, baseline))
    if report.gate(findings, baseline):
        raise PhaseError("analysis: new findings against the baseline")

    # ---- c. the analyzing launcher at full width ------------------------------
    root = Path(__file__).resolve().parent
    env = dict(__import__("os").environ)
    env["PYTHONPATH"] = str(root / "src") + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *launcher_argv],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("analyze:")]
    for ln in lines:
        print(f"[analysis] launcher: {ln}")
    if proc.returncode != 0 or "analyze: recompile audit clean" not in lines:
        raise PhaseError(f"analysis: launch.serve {' '.join(launcher_argv)} "
                         f"exited {proc.returncode}: "
                         f"{proc.stderr[-2000:]}{proc.stdout[-2000:]}")
    out["launcher_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[analysis] launcher took {out['launcher_s']:.1f} s; phase 20 "
          f"took {out['phase_s']:.1f} s")
    return out


def _launcher(module: str, argv, ranks: int = 0, timeout: int = 600):
    """`python -m module argv`, or under `torchrun --standalone
    --nproc-per-node ranks`; -> (wall s, stdout). Raises PhaseError on a
    non-zero exit."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m"]
    if ranks:
        cmd += ["torch.distributed.run", "--standalone", "--nproc-per-node",
                str(ranks), "-m"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + [module, *argv], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise PhaseError(f"mesh: {' '.join(cmd[2:] + [module, *argv])} "
                         f"exited {proc.returncode}: {proc.stderr[-3000:]}"
                         f"{proc.stdout[-1500:]}")
    return wall, proc.stdout


def _tagged(stdout: str, tag: str):
    """The JSON after `tag` on the launcher's line that starts with it."""
    for ln in stdout.splitlines():
        if ln.startswith(tag):
            return json.loads(ln[len(tag):])
    raise PhaseError(f"mesh: no {tag!r} line in the launcher's output")


def _launches(stdout: str) -> dict:
    """{'K1': n, ...} from the launcher's 'kernel launches: K1 n, ...'."""
    for ln in stdout.splitlines():
        if "kernel launches:" in ln:
            part = ln.split("kernel launches:", 1)[1]
            out = {}
            for item in part.split(","):
                k, _, v = item.strip().partition(" ")
                out[k] = int(v)
            return out
    raise PhaseError("mesh: no kernel launch counts in the launcher's output")


def _streams(stdout: str) -> list:
    return [ln.split(": ", 1)[1] for ln in stdout.splitlines()
            if ln.startswith("request ")]


def tp2_local_checks(dev, cfg, n: int, alpha: float, sync, sites=None,
                     k3_cfg=None, tag: str = "mesh",
                     label: str = "[mesh] (d)") -> dict:
    """Phase 21d: the local calls a rank of a 1x2 (data 1, model 2) mesh
    makes, in process (two ranks cannot share the card). K2 on each
    zero-padded half of a ΔW cotangent column-sharded over `model` (what
    dist/dtensor.py's ShardedDelta backward hands it) at wq and wv, every
    layer: each half within K2's tolerance of the plain version on the
    same input, and the two halves' sum within REL_TO_PLAIN of the whole
    cotangent's K2 and of its plain version (K2 is linear in g). K3 on a
    rank's half of the query and KV heads (what local_paged_attention
    hands it) at the serve launcher's cache (2 slots, pages of 16, 128
    rows), bf16: each half within agreement_limit of the plain version,
    and the halves side by side within agreement_limit of the whole
    heads' K3. `sites` ((name, d1, d2) of cfg's stacks; default wq and
    wv) and `k3_cfg` (the heads; default cfg's) pick the shapes; phase 22
    passes mamba2's wx/wo_ssm and olmoe's 16 heads and requires the
    halves side by side to equal the whole bit for bit."""
    import torch
    from repro_torch.core.fourierft import sample_entries
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import paged_attention as pak
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    out = {"K2": {}, "K3": {}}
    L = cfg.num_layers
    sites = sites or (("wq", cfg.d_model, cfg.attn_dim),
                      ("wv", cfg.d_model, cfg.kv_dim))
    for site, d, d2 in sites:
        entries = sample_entries(d, d2, n, seed=7).to(dev)
        u, v = padded_entries(entries, n, fdk.NC)
        g = torch.randn((L, d, d2), generator=gen, device=dev)
        whole = fdk.dc(g, u, v, d, d2, alpha)
        ref_whole = fdk.dc_reference(g, u, v, d, d2, alpha)
        summed, half_err = torch.zeros_like(whole), 0.0
        for r in range(2):
            cols = slice(r * d2 // 2, (r + 1) * d2 // 2)
            gp = torch.zeros_like(g)
            gp[..., cols] = g[..., cols]
            got = fdk.dc(gp, u, v, d, d2, alpha)
            ref = fdk.dc_reference(gp, u, v, d, d2, alpha)
            sync()
            diff = (got - ref).abs()
            err, scale = float(diff.max()), float(ref.abs().max())
            if bool((diff > 2e-3 + 1e-4 * ref.abs()).any()) \
                    or err > REL_TO_PLAIN * scale \
                    or not torch.isfinite(got).all():
                raise PhaseError(f"mesh: K2 on rank {r}'s zero-padded half "
                                 f"of {site}'s cotangent: max |kernel - "
                                 f"plain| {err:.3e} (max |plain| "
                                 f"{scale:.3e})")
            half_err = max(half_err, err)
            summed += got
            del gp, got, ref, diff
        scale = float(ref_whole.abs().max())
        to_whole = float((summed - whole).abs().max())
        sum_plain = float((summed - ref_whole).abs().max())
        if max(to_whole, sum_plain) > REL_TO_PLAIN * scale:
            raise PhaseError(f"mesh: K2 of {site}'s two halves summed is "
                             f"{to_whole:.3e} from K2 of the whole, "
                             f"{sum_plain:.3e} from the plain version "
                             f"(limit {REL_TO_PLAIN * scale:.3e})")
        out["K2"][site] = {"shape": [L, d, d2], "half_max_abs_err": half_err,
                           "sum_to_whole": to_whole, "sum_to_plain": sum_plain,
                           "limit": REL_TO_PLAIN * scale}
        print(f"{label} K2 at {site} ({L}x{d}x{d2}), each rank's "
              f"zero-padded half of {d2 // 2} columns: max |kernel - plain| "
              f"{half_err:.3e}; halves summed {to_whole:.3e} from the whole's "
              f"K2, {sum_plain:.3e} from its plain version (limit "
              f"{REL_TO_PLAIN * scale:.3e})")
        del g, whole, ref_whole, summed
    hc = k3_cfg or cfg
    H, K, dh = hc.n_heads, hc.n_kv, hc.head_dim
    B, ps, pps = 2, 16, 128 // 16
    bt = torch.arange(B * pps, dtype=torch.int32,
                      device=dev).reshape(B, pps) + 1
    kv_len = torch.tensor([pps * ps - 3, 37], dtype=torch.int32, device=dev)
    dtype = torch.bfloat16
    q = torch.randn((B, 1, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((B * pps + 1, ps, K, dh), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((B * pps + 1, ps, K, dh), generator=gen,
                     device=dev).to(dtype)
    whole = pak.paged_attention(q, kp, vp, bt, kv_len)
    halves, share = [], 0.0
    for r in range(2):
        hs = slice(r * H // 2, (r + 1) * H // 2)
        ks = slice(r * K // 2, (r + 1) * K // 2)
        ql, kl, vl = (q[:, :, hs].contiguous(), kp[:, :, ks].contiguous(),
                      vp[:, :, ks].contiguous())
        got = pak.paged_attention(ql, kl, vl, bt, kv_len)
        ref = pak.paged_attention_reference(ql.float(), kl.float(),
                                            vl.float(), bt, kv_len)
        sync()
        share = max(share, float(((got.float() - ref).abs()
                                  / pak.agreement_limit(ref, dtype)).max()))
        if share > 1.0 or not torch.isfinite(got.float()).all():
            raise PhaseError(f"mesh: K3 on rank {r}'s {H // 2} query and "
                             f"{K // 2} KV heads: {share:.3f} of "
                             "agreement_limit")
        halves.append(got)
    side = torch.cat(halves, dim=2)
    to_whole = float(((side.float() - whole.float()).abs()
                      / pak.agreement_limit(whole.float(), dtype)).max())
    if to_whole > 1.0:
        raise PhaseError(f"mesh: K3 on the two ranks' heads side by side is "
                         f"{to_whole:.3f} of agreement_limit from the whole "
                         "heads' K3")
    out["K3"] = {"local_heads": [H // 2, K // 2], "head_dim": dh,
                 "share_of_limit": share, "halves_to_whole": to_whole,
                 "halves_equal_whole": bool(torch.equal(side, whole))}
    if k3_cfg is not None and not out["K3"]["halves_equal_whole"]:
        raise PhaseError(f"{tag}: K3 on the two ranks' heads side by side "
                         "is not bit-identical to the whole heads' K3")
    print(f"{label} K3 on a rank's {H // 2} query and {K // 2} KV heads "
          f"(head_dim {dh}, bf16): {share:.3f} of agreement_limit; the two "
          f"ranks' heads side by side {to_whole:.3f} of it from the whole "
          f"heads' K3 (bit-identical: {out['K3']['halves_equal_whole']})")
    return out


def mesh_phase(dev, cfg) -> dict:
    """Phase 21: the placement layer and the sharded train and serve paths
    on the card (module docstring). Returns the launch counts and times
    for the kernels line."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.dist import cost_model, planner
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import build
    out = {}
    t_phase = time.perf_counter()

    # ---- a. sharded training, one rank, against the plain-tensor path ------
    targs = ["--arch", "yi-6b", "--steps", str(MESH_STEPS), "--batch", "8",
             "--seq", "64"]
    wall_m, meshed = _launcher(
        "repro_torch.launch.train",
        targs + ["--model-parallel", "1", "--grad-compression", "int8_ef",
                 "--sharding-plan", "search"], ranks=1)
    wall_p, plain_c = _launcher("repro_torch.launch.train",
                                targs + ["--grad-compression", "int8_ef"])
    if "mesh=1x1" not in meshed or "sharding plan: {'source': 'plan'" \
            not in meshed:
        raise PhaseError("mesh: the torchrun run did not report its 1x1 "
                         "mesh and searched plan")
    lm, lp = _tagged(meshed, "losses: "), _tagged(plain_c, "losses: ")
    if not all(math.isfinite(v) for v in lm):
        raise PhaseError(f"mesh: non-finite losses {lm}")
    # one rank runs the same kernels on the same local tensors as the
    # plain path (deterministic: no float atomics), so the losses and the
    # trained coefficients must be the same numbers, not merely close
    rel = max(abs(a - b) / abs(b) for a, b in zip(lm, lp))
    if lm != lp:
        raise PhaseError(f"mesh: DTensor losses {lm} vs plain {lp}: "
                         f"relative {rel:.2e}, not equal")
    nm = _tagged(meshed, "adapter_norms: ")
    np_ = _tagged(plain_c, "adapter_norms: ")
    if set(nm) != {"layers/wq/c", "layers/wv/c"} or nm != np_:
        raise PhaseError(f"mesh: trained |c| per site DTensor {nm} vs "
                         f"plain {np_}, not equal")
    kl = _launches(meshed)
    if kl["K1"] < 1 or kl["K2"] < 1:
        raise PhaseError(f"mesh: K1/K2 did not launch on the DTensor path "
                         f"({kl})")

    def warm(stdout):
        ms = _tagged(stdout, "step_ms: ")[1:]
        return statistics.median(ms), min(ms), max(ms)

    out["train"] = {"losses_dtensor": lm, "losses_plain": lp,
                    "max_rel": rel, "adapter_norms": nm, "launches": kl,
                    "warm_ms_dtensor": warm(meshed),
                    "warm_ms_plain": warm(plain_c),
                    "wall_s": {"plain": wall_p, "torchrun": wall_m}}
    print(f"[mesh] (a) 1-rank DTensor train, int8_ef, searched plan: "
          f"losses {lm}; plain path {lp} (max relative {rel:.2e}); trained "
          f"|c| {nm}, equal; warm "
          f"step ms (median, min, max) DTensor {warm(meshed)}, plain "
          f"{warm(plain_c)}; K1 {kl['K1']} K2 {kl['K2']}")
    # the same two runs at --microbatch 2: the placed batch's rows are
    # ordered (train.step.place_batch) so that the DTensor step's
    # every-other-row split is the plain step's two contiguous halves
    margs = ["--arch", "yi-6b", "--steps", str(MESH_MB_STEPS), "--batch",
             "8", "--seq", "64", "--microbatch", "2", "--grad-compression",
             "int8_ef"]
    _, meshed_mb = _launcher(
        "repro_torch.launch.train",
        margs + ["--model-parallel", "1", "--sharding-plan", "search"],
        ranks=1)
    _, plain_mb = _launcher("repro_torch.launch.train", margs)
    lm2, lp2 = _tagged(meshed_mb, "losses: "), _tagged(plain_mb, "losses: ")
    nm2 = _tagged(meshed_mb, "adapter_norms: ")
    np2 = _tagged(plain_mb, "adapter_norms: ")
    if not all(math.isfinite(v) for v in lm2) or lm2 != lp2 or nm2 != np2:
        raise PhaseError(f"mesh: at microbatch 2 DTensor losses {lm2} and "
                         f"|c| {nm2} vs plain {lp2} and {np2}: not equal")
    kl2 = _launches(meshed_mb)
    want = MESH_MB_STEPS * 2 * 2
    if kl2["K1"] != want or kl2["K2"] != want:
        raise PhaseError(f"mesh: at microbatch 2 the DTensor run launched "
                         f"{kl2}; expected K1 = K2 = {want} (steps x 2 "
                         "microbatches x 2 sites)")
    out["train_microbatch"] = {"losses_dtensor": lm2, "losses_plain": lp2,
                               "adapter_norms": nm2, "launches": kl2}
    print(f"[mesh] (a) the same at --microbatch 2, {MESH_MB_STEPS} steps: "
          f"DTensor losses {lm2} and trained |c| {nm2} equal the plain "
          f"path's; K1 {kl2['K1']} K2 {kl2['K2']}")

    # ---- b. sharded serving, one rank, against the plain-tensor path --------
    sargs = ["--arch", "yi-6b", "--continuous", "--trace-n", "8",
             "--max-new", "8"]
    _, splain = _launcher("repro_torch.launch.serve", sargs)
    _, smesh = _launcher("repro_torch.launch.serve",
                         sargs + ["--sharding-plan", "search"], ranks=1)
    a, b = _streams(smesh), _streams(splain)
    if len(a) != 8 or a != b:
        raise PhaseError(f"mesh: DTensor streams {a} vs plain {b}")
    ks = _launches(smesh)
    if ks["K3"] < 1 or ks["K1"] < 1:
        raise PhaseError(f"mesh: K1/K3 did not launch on the DTensor "
                         f"serving path ({ks})")
    out["serve"] = {"launches": ks, "streams_equal": True}
    print(f"[mesh] (b) 1-rank DTensor serve: {len(a)} streams equal the "
          f"plain path's; K1 {ks['K1']} (merge) K3 {ks['K3']}")

    # ---- d. what a rank of a 1x2 model-parallel mesh hands the kernels ----
    out["tp2_local"] = tp2_local_checks(dev, cfg, 1000, 300.0,
                                        torch.cuda.synchronize)

    # ---- c. the planner at production scale (meta tensors) -----------------
    t0 = time.perf_counter()
    pmodel = build(cfg, PEFTConfig(method="fourierft", n=1000, alpha=300.0),
                   remat="full")
    pmesh = mesh_mod.make_production_mesh()
    plan = planner.plan_model(pmodel, pmesh,
                              shape=configs.shape_for("train_4k"),
                              env=cost_model.default_env(pmesh))
    ranked = plan.meta["ranked"]
    rules = next(r for r in ranked if r["strategy"] == "rules")
    if ranked[0]["objective_s"] > rules["objective_s"]:
        raise PhaseError("mesh: the searched plan scores worse than rules")
    out["plan"] = {"strategy": plan.meta["strategy"],
                   "winner": plan.meta["cost"],
                   "objective_s": ranked[0]["objective_s"],
                   "rules_objective_s": rules["objective_s"],
                   "hbm_bytes": cost_model.device_hbm_bytes(dev),
                   "plan_s": time.perf_counter() - t0}
    print(f"[mesh] (c) yi-6b 16x16 train_4k on the card's constants "
          f"(HBM {out['plan']['hbm_bytes'] / 1e9:.1f} GB): winner "
          f"{plan.meta['strategy']} predicted {plan.meta['cost']['total_s']}"
          f" s a step (objective {ranked[0]['objective_s']} s) vs rules "
          f"{rules['objective_s']} s; planned in {out['plan']['plan_s']:.1f}"
          f" s")

    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[mesh] phase 21 took {out['phase_s']:.1f} s")
    print(json.dumps({"mesh": out}))
    return out


DRYRUN_CELLS = (("yi-6b", "train_4k", "rules"),
                ("yi-6b", "decode_32k", "rules"),
                ("olmoe-1b-7b", "train_4k", "rules"),
                ("yi-6b", "train_4k", "search"))


def _start_dryruns(out_dir: Path):
    """Phase 22f's cells, each `launch.dryrun` in a process of its own
    (a fake group of 256 ranks is global), all started at once: they run
    on the host's cores while the card serves (a)-(e)."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for arch, shape, plan in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "single", "--route", "card",
               "--out", str(out_dir), "--force", "--variant",
               "baseline" if plan == "rules" else plan,
               "--sharding-plan", plan]
        procs.append(((arch, shape, plan), subprocess.Popen(
            cmd, cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def _finish_dryruns(procs, out_dir: Path, hbm: float, timeout: float):
    """Wait for phase 22f's cells; -> {cell: result JSON}."""
    from repro_torch.launch.dryrun_lib import cell_tag
    out = {}
    deadline = time.perf_counter() + timeout
    for (arch, shape, plan), p in procs:
        try:
            so, se = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            raise PhaseError(f"families mesh: dry run {arch} {shape} {plan} "
                             f"did not finish in {timeout:.0f} s")
        if p.returncode != 0:
            raise PhaseError(f"families mesh: dry run {arch} {shape} {plan} "
                             f"exited {p.returncode}: {se[-3000:]}")
        variant = "baseline" if plan == "rules" else plan
        with open(out_dir / (cell_tag(arch, shape, False, variant)
                             + ".json")) as fh:
            res = json.load(fh)
        m = res["memory"]
        if res["route"] != "card" or not res["flops_per_device"] > 0:
            raise PhaseError(f"families mesh: dry run {arch} {shape}: "
                             f"route {res['route']}, flops "
                             f"{res['flops_per_device']}")
        if res["kind"] == "train" and res["kernel_counts"].get(
                "fourier_deltaw", 0) < 1:
            raise PhaseError(f"families mesh: the card-route dry run of "
                             f"{arch} {shape} traced no K1 "
                             f"({res['kernel_counts']})")
        if abs(m["hbm_bytes"] - hbm) > 1:
            raise PhaseError(f"families mesh: dry run read {m['hbm_bytes']} "
                             f"bytes of memory, the card has {hbm}")
        out[f"{arch} {shape} {plan}"] = res
        print(f"[families mesh] (f) {arch} {shape} on 16x16 ({plan}, card "
              f"route): flops/dev {res['flops_per_device']:.4e} (dot "
              f"{res['dot_flops_per_device']:.4e}), bytes/dev "
              f"{res['bytes_per_device']:.4e} (upper "
              f"{res['bytes_per_device_upper']:.4e}), collectives "
              f"{json.dumps(res['collectives'])} "
              f"({res['collective_bytes_per_device']:.4e} B), kernels "
              f"{json.dumps(res['kernel_counts'])}, peak "
              f"{m['peak_estimate_bytes'] / 1e9:.2f} GB (args "
              f"{m['argument_bytes'] / 1e9:.2f}, temp "
              f"{m['temp_bytes'] / 1e9:.2f}), fits_hbm {m['fits_hbm']} "
              f"against the card's {hbm / 1e9:.1f} GB; dominant "
              f"{res['dominant']}, traced in {res['compile_seconds']:.1f} s")
    rules = out["yi-6b train_4k rules"]["collective_bytes_per_device"]
    search = out["yi-6b train_4k search"]["collective_bytes_per_device"]
    if search > rules:
        raise PhaseError(f"families mesh: yi-6b train_4k, the searched plan "
                         f"moves {search:.4e} collective bytes a device, "
                         f"more than the rules' {rules:.4e}")
    print(f"[families mesh] (f) yi-6b train_4k: searched plan {search:.4e} "
          f"collective bytes a device, rules {rules:.4e}")
    return out


def _gateway_run(flags, prompts, max_new: int):
    """`launch.api` under `torchrun --nproc-per-node 1` (the broadcast
    pump on a one-rank group): post each prompt in turn, read the
    streams, stop rank 0 by its pid. -> (token lists, stdout)."""
    import os
    import signal
    import urllib.request
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.api", *flags,
         "--port", "0"], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if "gateway listening on http://127.0.0.1:" not in line:
            proc.kill()
            raise PhaseError(f"families mesh: the API launcher did not "
                             f"start: {line}{proc.stderr.read()[-3000:]}")
        port = int(line.split("127.0.0.1:")[1].split()[0])
        pid = int(line.split("pid ")[1].split(")")[0])
        streams = []
        for p in prompts:
            body = json.dumps({"model": "base", "prompt": p,
                               "max_tokens": max_new,
                               "stream": False}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/completions", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                streams.append(json.loads(r.read())["choices"][0]
                               ["token_ids"])
        os.kill(pid, signal.SIGTERM)
        so, se = proc.communicate(timeout=120)
    except BaseException:
        proc.kill()
        raise
    if proc.returncode != 0 or "gateway shutting down" not in so:
        raise PhaseError(f"families mesh: the API launcher exited "
                         f"{proc.returncode}: {se[-3000:]}")
    return streams, line + so


def families_mesh_phase(dev, tenant_cfg) -> dict:
    """Phase 22: every family, the adapter bank and the gateway on the
    mesh path, one rank on the card, against the same runs with no
    process group; a 1x2 rank's kernel calls in process; the production
    dry run's cells on the card route (module docstring). Returns the
    launch counts for the kernels line."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.dist import cost_model
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import build
    from repro_torch.serve import AdapterBank, ContinuousScheduler, Engine
    from repro_torch.serve.engine import Request
    out = {}
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    dry_dir = root / "build" / "dryrun22"
    tenant_dir = root / "build" / "tenants22"
    procs = _start_dryruns(dry_dir)
    # each part's wall seconds, the dry runs' wait as f
    parts, t_part = {}, time.perf_counter()

    def part_done(tag):
        nonlocal t_part
        now = time.perf_counter()
        parts[tag], t_part = now - t_part, now
    try:
        # ---- a/b. olmoe and mamba2 at full size: train and serve -------
        for key, arch, steps, layers in (("olmoe", "olmoe-1b-7b", 3, 16),
                                         ("mamba2", "mamba2-2.7b", 2, 64)):
            targs = ["--arch", arch, "--steps", str(steps), "--batch", "1",
                     "--seq", "2048"]
            if key == "mamba2":
                # 64 layers at S 2048 keep every activation without it
                # (phase 19 trains mamba2 so too)
                targs += ["--remat", "full"]
            wall_m, meshed = _launcher("repro_torch.launch.train",
                                       targs + ["--model-parallel", "1"],
                                       ranks=1)
            wall_p, plain = _launcher("repro_torch.launch.train", targs)
            if "mesh=1x1" not in meshed:
                raise PhaseError(f"families mesh: {arch} under torchrun did "
                                 "not report its 1x1 mesh")
            lm, lp = _tagged(meshed, "losses: "), _tagged(plain, "losses: ")
            nm = _tagged(meshed, "adapter_norms: ")
            np_ = _tagged(plain, "adapter_norms: ")
            if not all(math.isfinite(v) for v in lm) or lm != lp \
                    or nm != np_:
                raise PhaseError(f"families mesh: {arch} DTensor losses {lm} "
                                 f"|c| {nm} vs plain {lp} {np_}: not equal")
            kl = _launches(meshed)
            if kl.get("K1") != 2 * steps or kl.get("K2") != 2 * steps:
                raise PhaseError(f"families mesh: {arch} launched {kl}; "
                                 f"expected K1 = K2 = 2 sites x {steps} "
                                 "steps")
            ms = _tagged(meshed, "step_ms: ")[1:]
            mp = _tagged(plain, "step_ms: ")[1:]
            rec = {"losses": lm, "adapter_norms": nm, "launches": kl,
                   "warm_ms_dtensor": statistics.median(ms),
                   "warm_ms_plain": statistics.median(mp)}
            print(f"[families mesh] ({'a' if key == 'olmoe' else 'b'}) "
                  f"{arch} 1-rank DTensor train, {steps} steps of 1 x 2048: "
                  f"losses {lm} equal the plain path's; trained |c| {nm} "
                  f"equal; K1 {kl['K1']} K2 {kl['K2']}; warm step median "
                  f"DTensor {rec['warm_ms_dtensor']:.1f} ms, plain "
                  f"{rec['warm_ms_plain']:.1f} ms")
            sargs = ["--arch", arch, "--max-new", "8"]
            if key == "olmoe":
                sargs += ["--continuous", "--trace-n", "8"]
            wall_sp, splain = _launcher("repro_torch.launch.serve", sargs)
            wall_sm, smesh = _launcher("repro_torch.launch.serve", sargs,
                                       ranks=1)
            rec["wall_s"] = {"train_torchrun": wall_m, "train_plain": wall_p,
                             "serve_plain": wall_sp,
                             "serve_torchrun": wall_sm}
            pick = _streams if key == "olmoe" else (
                lambda so: [ln for ln in so.splitlines()
                            if ln.startswith("prompt ")])
            a, b = pick(smesh), pick(splain)
            if not a or a != b:
                raise PhaseError(f"families mesh: {arch} DTensor streams "
                                 f"{a} vs plain {b}")
            rec["streams"] = len(a)
            if key == "olmoe":
                ks = _launches(smesh)
                steps_line = next(ln for ln in smesh.splitlines()
                                  if ln.startswith("continuous: "))
                nsteps = int(steps_line.split(" steps")[0].split()[-1])
                if ks["K3"] != nsteps * layers:
                    raise PhaseError(f"families mesh: olmoe served K3 "
                                     f"{ks['K3']} times; expected {nsteps} "
                                     f"steps x {layers} layers")
                rec["serve_launches"] = ks
                rec["decode_steps"] = nsteps
            print(f"[families mesh] ({'a' if key == 'olmoe' else 'b'}) "
                  f"{arch} 1-rank DTensor serve "
                  f"({'continuous' if key == 'olmoe' else 'lockstep'}): "
                  f"{len(a)} streams equal the plain path's"
                  + (f"; K3 {rec['serve_launches']['K3']} = "
                     f"{rec['decode_steps']} steps x {layers}, K1 "
                     f"{rec['serve_launches']['K1']} (merge)"
                     if key == "olmoe" else ""))
            out[key] = rec
            part_done("a" if key == "olmoe" else "b")

        # ---- c. the adapter bank on the DTensor engine -------------------
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            mesh = mesh_mod.make_host_mesh()
            bmodel = build(tenant_cfg, PEFTConfig(method="none"))
            bparams = bmodel.init(0, dev)
            profiles, tenant_ids = bank_tenants(dev, bmodel, bparams,
                                                tenant_dir)
            prompts = [torch.tensor([(7 * i + j) % tenant_cfg.vocab
                                     for j in range(5 + i)],
                                    dtype=torch.int32) for i in range(5)]
            streams = {}
            for tag, m in (("plain", None), ("dtensor", mesh)):
                bank = AdapterBank(bmodel, profiles, capacity=3,
                                   checkpoint_dir=str(tenant_dir),
                                   device=dev)
                eng = Engine(bmodel, bparams, batch_slots=4, max_len=64,
                             bank=bank, device=dev, mesh=m)
                sched = ContinuousScheduler(eng, page_size=16)
                reqs = [Request(prompt=p, max_new=8, adapter_id=tid)
                        for p, tid in zip(prompts, tenant_ids)]
                sched.serve(reqs)
                streams[tag] = [r.out for r in reqs]
                del sched, eng, bank
            if streams["dtensor"] != streams["plain"]:
                raise PhaseError(f"families mesh: the bank on the DTensor "
                                 f"engine streamed {streams['dtensor']}, "
                                 f"the plain bank {streams['plain']}")
        finally:
            dist.destroy_process_group()
        out["bank"] = {"tenants": len(prompts), "streams_equal": True}
        print(f"[families mesh] (c) the adapter bank (phase 13's five "
              f"tenants, capacity 3) on the DTensor engine of a one-rank "
              f"group: {len(prompts)} streams equal the plain bank's")
        part_done("c")

        # ---- d. the API launcher under torchrun, through the pump --------
        flags = ["--arch", "yi-6b", "--layers", "2", "--dtype", "float32",
                 "--slots", "4", "--max-len", "128"]
        gprompts = [[1, 2, 3, 4], [5, 6, 7], [1, 2, 3, 4, 9, 10], [11]]
        got, gout = _gateway_run(flags, gprompts, 8)
        from repro_torch.launch import api as launch_api
        ap = launch_api.argparse.ArgumentParser()
        launch_api.add_model_args(ap)
        sched, _ = launch_api.build_scheduler(ap.parse_args(flags))
        want = []
        for p in gprompts:
            r = Request(prompt=torch.tensor(p, dtype=torch.int32),
                        max_new=8)
            sched.serve([r])
            want.append(r.out)
        del sched
        if got != want or "1 ranks" not in gout:
            raise PhaseError(f"families mesh: the gateway under torchrun "
                             f"streamed {got}, the replay {want}")
        out["gateway"] = {"requests": len(got), "streams_equal": True}
        print(f"[families mesh] (d) launch.api under torchrun (one rank, "
              f"the broadcast pump): {len(got)} HTTP streams equal the "
              "in-process replay")
        part_done("d")

        # ---- e. a 1x2 rank's kernel calls, in process --------------------
        mcfg = configs.get("mamba2-2.7b")
        d_inner = mcfg.ssm.expand * mcfg.d_model
        out["tp2_local"] = tp2_local_checks(
            dev, mcfg, 1000, 300.0, torch.cuda.synchronize,
            sites=(("wx", mcfg.d_model, d_inner),
                   ("wo_ssm", d_inner, mcfg.d_model)),
            k3_cfg=configs.get("olmoe-1b-7b"), tag="families mesh",
            label="[families mesh] (e)")
        torch.cuda.empty_cache()
        part_done("e")

        # ---- f. the production dry run on the card route ------------------
        out["dryrun"] = _finish_dryruns(
            procs, dry_dir, cost_model.device_hbm_bytes(dev), 900.0)
        procs = []
        part_done("f")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
    out["phase_s"] = time.perf_counter() - t_phase
    out["part_s"] = parts
    print(f"[families mesh] parts (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + "; (a)/(b) subprocess walls: " + "; ".join(
              f"{k} " + ", ".join(f"{n} {w:.1f}"
                                  for n, w in out[k]["wall_s"].items())
              for k in ("olmoe", "mamba2")))
    print(f"[families mesh] phase 22 took {out['phase_s']:.1f} s")
    print(json.dumps({"families_mesh": {
        k: v for k, v in out.items() if k != "dryrun"}}))
    return out



def _smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def _captured(fn, argv):
    """(what `fn(argv)` returned, its standard output); the output is
    echoed after the call."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = fn(argv)
    return got, buf.getvalue()


def entry_points_phase(dev, work: Path, model_flags=None,
                       example_args=()) -> dict:
    """Phase 23 (module docstring): the port's load harness against the
    API launcher on the card, then the four examples at their own sizes,
    in process. `work` is a git-ignored directory for the demo bank and
    the loadgen's results. `model_flags` replaces the launcher's model
    flags and `example_args` is added to each example's argv (a rehearsal
    on the CPU passes `--reduced ... --device cpu` and `--device cpu
    --steps N`). Returns the loadgen's summary, the examples' figures and
    the launches; raises PhaseError when a check fails."""
    import os
    import signal
    from repro_torch.examples import (expressiveness_2d, quickstart,
                                      serve_batched, train_peft_100m)
    from repro_torch.launch import api as launch_api
    from repro_torch.launch import loadgen
    t_phase = time.perf_counter()
    out = {"launches": {}}
    root = Path(__file__).resolve().parent
    work.mkdir(parents=True, exist_ok=True)
    smi = _smi_line()

    # ---- a. launch.api on the card, driven by the port's loadgen -----------
    flags = list(model_flags or ["--arch", "yi-6b", "--layers",
                                 str(SLICE_LAYERS), "--dtype", "float32"])
    demo = work / "demo_bank"
    _captured(launch_api.main, flags + ["--export-demo-bank", str(demo)])
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.api", *flags,
         "--bank-dir", str(demo), "--port", "0"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    results = work / "loadgen.json"
    try:
        line = proc.stdout.readline()
        if "gateway listening on http://127.0.0.1:" not in line:
            proc.kill()
            raise PhaseError(f"entry points: launch.api did not listen: "
                             f"{line}{proc.communicate()[1][-3000:]}")
        boot_s = time.perf_counter() - t0
        port = int(line.split("127.0.0.1:")[1].split()[0])
        argv = ["--port", str(port), "--n", "48", "--rate", "16",
                "--models", "base,adapter:t0,adapter:t1", "--zipf-a", "1.2",
                "--shared-frac", "0.5", "--priorities",
                "interactive:0.25,batch:0.75", "--max-new", "16",
                "--verify", "--out", str(results), *flags, "--bank-dir",
                str(demo)]
        # the replay's scheduler, kept to read its decode rounds
        built, build_scheduler = [], launch_api.build_scheduler

        def keep(args_):
            built.append(build_scheduler(args_))
            return built[-1]
        launch_api.build_scheduler = keep
        zero_counts()
        try:
            _, text = _captured(loadgen.main, argv)
            code = 0
        except SystemExit as e:
            code, text = e.code, ""
        finally:
            launch_api.build_scheduler = build_scheduler
        replay = launch_counts()
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    if code not in (0, None):
        raise PhaseError(f"entry points: the loadgen exited {code}: "
                         f"{err[-2000:]}")
    if "verify: 48 streams replayed, 0 mismatches" not in text:
        raise PhaseError(f"entry points: the loadgen's replay: "
                         f"{text[-2000:]}")
    if proc.returncode != 0:
        raise PhaseError(f"entry points: launch.api exited "
                         f"{proc.returncode}: {err[-2000:]}")
    summary = json.loads(results.read_text())["summary"]
    rsched = built[0][0]
    rounds, layers = rsched.metrics.steps, rsched.engine.model.cfg.num_layers
    if summary["ok"] != 48 or len(built) != 1 or not rounds \
            or replay["K3"] != rounds * layers:
        raise PhaseError(f"entry points: {summary['ok']} of 48 requests "
                         f"completed, the replay launched {replay} over "
                         f"{rounds} decode rounds x {layers} layers")
    out["loadgen"] = {k: summary[k] for k in (
        "n", "ok", "retries", "throttled_429", "wall_s", "tok_s",
        "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms",
        "latency_p50_ms", "latency_p99_ms", "by_model")}
    out["loadgen"]["boot_s"] = boot_s
    out["loadgen"]["replay_rounds"] = rounds
    out["launches"]["replay"] = replay
    print(f"[entry] (a) launch.api (yi-6b, {SLICE_LAYERS} layers, f32, the "
          f"demo bank; up in {boot_s:.1f} s) driven by "
          f"repro_torch.launch.loadgen: 48 requests at 16 req/s over base, "
          f"adapter:t0, adapter:t1 (zipf 1.2, shared prefix 0.5, "
          f"interactive 0.25): TTFT p50 {summary['ttft_p50_ms']:.2f} ms, "
          f"p99 {summary['ttft_p99_ms']:.2f} ms, inter-token p50 "
          f"{summary['itl_p50_ms']:.2f} ms, {summary['tok_s']:.1f} "
          f"tokens/s, {summary['throttled_429']} 429s "
          f"({summary['retries']} retries); --verify: 48 streams "
          f"bit-identical to the in-process replay (K3 {replay['K3']} = "
          f"{rounds} decode rounds x {layers} layers); "
          f"{smi}")

    # ---- b. the four examples at their own sizes ---------------------------
    zero_counts()
    figs = {}
    got, text = _captured(quickstart.main, list(example_args))
    losses = got["losses"]
    if not losses[-1] < losses[0] or [len(g) for g in got["generated"]] \
            != [12, 12] or not all(math.isfinite(x) for x in losses):
        raise PhaseError(f"entry points: quickstart's loss {losses[0]} -> "
                         f"{losses[-1]}, generated {got['generated']}")
    figs["quickstart"] = {"first": losses[0], "final": losses[-1],
                          "steps": len(losses),
                          "anomalies": got["anomalies"],
                          "generated": got["generated"]}
    last = [ln for ln in text.splitlines() if ln.startswith("loss ")]
    print(f"[entry] (b) quickstart: {last[-1]}; generated "
          f"{got['generated']}")
    got, text = _captured(serve_batched.main, list(example_args))
    if any([len(o) for o in outs] != [8, 8, 8]
           for outs in got["served"].values()):
        raise PhaseError(f"entry points: serve_batched served "
                         f"{got['served']}")
    figs["serve_batched"] = got
    print(f"[entry] (b) serve_batched: final losses "
          f"{ {k: round(v, 4) for k, v in got['losses'].items()} }, three "
          f"tenants merged and served 3 prompts x 8 tokens each")
    got, text = _captured(train_peft_100m.main, list(example_args))
    if not all(math.isfinite(r["final"]) for r in got.values()):
        raise PhaseError(f"entry points: train_peft_100m gave {got}")
    figs["train_peft_100m"] = got
    print(f"[entry] (b) train_peft_100m: {text.strip().splitlines()[-1]}")
    got, text = _captured(expressiveness_2d.main, list(example_args))
    lines = [ln for ln in text.splitlines()
             if ln.strip().startswith("reached 100% at epoch:")]
    if len(lines) != 2:
        raise PhaseError(f"entry points: expressiveness_2d printed "
                         f"{text[-1500:]}")
    figs["expressiveness_2d"] = {
        m: {"final_acc": got[m]["hist"][-1][2],
            "final_loss": got[m]["hist"][-1][1],
            "first_100": got[m]["first_100"]} for m in got}
    print(f"[entry] (b) expressiveness_2d: " + "; ".join(
        f"{m} final acc {f['final_acc']:.3f}, reached 100% at epoch "
        f"{f['first_100']}" for m, f in figs["expressiveness_2d"].items()))
    out["examples"] = figs
    out["launches"]["examples"] = launch_counts()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[entry] phase 23 took {out['phase_s']:.1f} s")
    print(json.dumps({"entry_points": out}, default=str))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"the port's package is not at {src / 'repro_torch'}")
    sys.path.insert(0, str(src))
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.core.fourierft import fourier_bases, sample_entries
    from repro_torch.core.adapter import dct_bases
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import dct_deltaw as ddk
    from repro_torch.kernels import fft_plan as fp
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import fused_attention as fak
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.serve import demo_prompts, demo_trace
    from repro_torch.models import build
    from repro_torch.serve import ContinuousScheduler, Engine
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def timed_ms(fn, iters: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # ---- 1. device ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"[device] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(smi[0] if smi else "nvidia-smi: no output")

    # ---- 2. build ------------------------------------------------------------
    secs = kbuild.build_all()
    print(f"[build] {len(kbuild.SIGNATURES)} kernel libraries in "
          f"{secs:.1f} s")
    for lib, log in kbuild.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}: {line.strip()}")

    # ---- 3. K1 ---------------------------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # (d1, d2, n, L, summed into the kernels line) of K1, K2, K4 and K5:
    # yi-6b wq and wv (phase 7's path), one ragged shape, qwen2.5-32b wq
    # (radix 5) and yi-6b's MLP (radix 43). K1 and K2 also at LLaMA2-7B's
    # q/v stack (phase 16a's path, L 32), held but not summed, so the
    # kernels line stays comparable with earlier runs.
    shapes = ((4096, 4096, 1000, 2, True), (4096, 512, 1000, 2, True),
              (300, 520, 37, 1, False), (5120, 5120, 1000, 1, False),
              (4096, 11008, 1000, 1, False))
    llama_qv = (4096, 4096, 1000, 32, False)
    # the families' q/v stacks (phase 18's paths), held and listed in the
    # kernels line's `family_shapes`, not summed: olmoe-1b-7b 2048x2048
    # (L 16), phi3.5-moe's wv 4096x1024 (L 4, phase 18c's cut; its wq is
    # yi-6b's 4096x4096), musicgen-medium 1536x1536 (L 48, radix 3),
    # qwen2-vl-72b 8192x8192 and 8192x1024
    # (L 2, phase 18e's cut); and phase 19's in/out projections, radix 5
    # and 7: mamba2-2.7b 2560x5120 and 5120x2560 (L 64), zamba2-7b 3584x7168
    # and 7168x3584 (L 81)
    family_qv = ((2048, 2048, 1000, 16, False), (4096, 1024, 1000, 4, False),
                 (1536, 1536, 1000, 48, False), (8192, 8192, 1000, 2, False),
                 (8192, 1024, 1000, 2, False), (2560, 5120, 1000, 64, False),
                 (5120, 2560, 1000, 64, False), (3584, 7168, 1000, 81, False),
                 (7168, 3584, 1000, 81, False))
    # qwen2-vl-72b's MLP up projection (phase 18e's wi, L 2): 29568 columns
    # are past one block's 29056, so each row pair takes a cluster of two
    # blocks; held and listed in the kernels line's `cluster_shapes`
    cluster_qv = ((8192, 29568, 1000, 2, False),)
    k1_family, k2_family, k1_cluster, k2_cluster = [], [], [], []

    def cluster_checked(tag, d1, d2, n):
        """The plan's blocks a row for this shape: 2 past CTA_ROW, else 1
        (the single-block kernel and its bits)."""
        want = 2 if d2 > fp.CTA_ROW else 1
        got = fp.fft_plan(d1, d2, n).cluster
        if got != want:
            raise PhaseError(f"{tag} {d1}x{d2}: the plan spans {got} blocks "
                             f"a row, expected {want}")
        return " (cluster of 2 blocks)" if got > 1 else ""
    k1 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "matmul_ms": 0.0,
          "err": 0.0, "flops": 0.0, "direct_flops": 0.0, "bytes": 0.0}
    for d1, d2, n, L, main_path in shapes + (llama_qv,) + family_qv \
            + cluster_qv:
        entries = sample_entries(d1, d2, n, seed=7).to(dev)
        u, v = padded_entries(entries, n, fdk.NC)
        try:
            how = cluster_checked("K1", d1, d2, u.shape[0])
        except PhaseError as e:
            return fail(str(e))
        c = torch.zeros((L, u.shape[0]), dtype=torch.float32, device=dev)
        c[:, :n] = torch.randn((L, n), generator=gen, device=dev)
        out = fdk.deltaw(c, u, v, d1, d2, 300.0)
        ref = fdk.deltaw_reference(c, u, v, d1, d2, 300.0)
        again = fdk.deltaw(c, u, v, d1, d2, 300.0)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        limit = min(2e-4, REL_TO_PLAIN * scale)
        if not torch.isfinite(out).all() or err > limit:
            return fail(f"K1 {d1}x{d2} n={n} L={L}: max |kernel - plain| "
                        f"{err:.3e} > {limit:.3e} (2e-4, or {REL_TO_PLAIN} "
                        f"of max |plain| {scale:.3e})")
        if not torch.equal(out, again):
            return fail(f"K1 {d1}x{d2}: two launches gave different bits")
        del again        # at L 81 each (L, d1, d2) f32 tensor is 8.3 GB
        ms = timed_ms(lambda: fdk.deltaw(c, u, v, d1, d2, 300.0), 20)
        plain_ms = timed_ms(
            lambda: fdk.deltaw_reference(c, u, v, d1, d2, 300.0), 5)
        # one torch.matmul of the pre-built rank-2n factors (per layer
        # A = [c·cosθ, -c·sinθ]·scale, B = [cosφ, sinφ])
        cos_t, sin_t, cos_p, sin_p = fourier_bases(torch.stack([u, v]), d1,
                                                   d2)
        a = torch.cat([cos_t[None] * c[:, None, :],
                       -sin_t[None] * c[:, None, :]], dim=2) \
            * (300.0 / (d1 * d2))
        b = torch.cat([cos_p, sin_p], dim=1).T.contiguous()
        mm_ms = timed_ms(lambda: torch.matmul(a, b), 5)
        del a, b
        # the library call for the same function: scatter the unpadded
        # coefficients into the dense spectrum, ifft2, real part (ref.py)
        cu, eu = c[:, :n].contiguous(), entries
        fft_err = float((kref.deltaw_ref(cu, eu, d1, d2, 300.0) - ref)
                        .abs().max())
        lib_ms = timed_ms(lambda: kref.deltaw_ref(cu, eu, d1, d2, 300.0),
                          20)
        flops, direct = fft_ops(d1, d2, L), 4.0 * d1 * d2 * n * L
        nbytes = 4.0 * (L * n + 2 * n + L * d1 * d2)
        b_ms, b_by = bound(flops, nbytes, "float32")
        print(f"[K1] {d1}x{d2}{how} n={n} L={L}: max_abs_err {err:.3e} = "
              f"{err / scale:.2e} of max |plain| {scale:.3e} (limit "
              f"{limit:.3e}) | kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, ifft2 {lib_ms:.3f} ms "
              f"(|ifft2 - plain| {fft_err:.1e}), matmul {mm_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), direct-sum FP32 floor "
              f"{direct / H100_PEAK['float32'] * 1e3:.3f} ms | kernel "
              f"{ms / b_ms:.1f}x its bound, {ms / lib_ms:.2f}x ifft2 | "
              "bit-identical on a second launch")
        k1["err"] = max(k1["err"], err)
        if (d1, d2, n, L, main_path) in family_qv + cluster_qv:
            (k1_cluster if how else k1_family).append({
                "d1": d1, "d2": d2, "n": n, "L": L, "max_abs_err": err,
                "max_abs_plain": scale, "limit": limit, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by})
        if main_path:
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("matmul_ms", mm_ms),
                             ("flops", flops), ("direct_flops", direct),
                             ("bytes", nbytes)):
                k1[key] += val
        del out, ref
    k1["bound_ms"], k1["bound_by"] = bound(k1["flops"], k1["bytes"],
                                           "float32")
    print(f"[K1] main shapes: kernel {k1['ms']:.3f} ms = "
          f"{k1['ms'] / k1['bound_ms']:.1f}x its bound "
          f"{k1['bound_ms']:.4f} ms, {k1['ms'] / k1['library_ms']:.2f}x "
          f"ifft2 ({k1['library_ms']:.3f} ms)")
    if k1["ms"] >= k1["library_ms"]:
        print("[K1] note: not faster than ifft2 in this run")

    # ---- 4. K2 ---------------------------------------------------------------
    k2 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "err": 0.0,
          "flops": 0.0, "direct_flops": 0.0, "bytes": 0.0}
    for d1, d2, n, L, main_path in shapes + (llama_qv,) + family_qv \
            + cluster_qv:
        entries = sample_entries(d1, d2, n, seed=7).to(dev)
        u, v = padded_entries(entries, n, fdk.NC)
        try:
            how = cluster_checked("K2", d1, d2, u.shape[0])
        except PhaseError as e:
            return fail(str(e))
        g = torch.randn((L, d1, d2), generator=gen, device=dev)
        out = fdk.dc(g, u, v, d1, d2, 300.0)
        ref = fdk.dc_reference(g, u, v, d1, d2, 300.0)
        again = fdk.dc(g, u, v, d1, d2, 300.0)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = float(diff.max())
        scale = float(ref.abs().max())
        if not torch.isfinite(out).all() or bool(
                (diff > 2e-3 + 1e-4 * ref.abs()).any()) \
                or err > REL_TO_PLAIN * scale:
            return fail(f"K2 {d1}x{d2} n={n} L={L}: max |kernel - plain| "
                        f"{err:.3e} beyond atol 2e-3, rtol 1e-4, or "
                        f"{REL_TO_PLAIN} of max |plain| {scale:.3e}")
        if not torch.equal(out, again):
            return fail(f"K2 {d1}x{d2}: two launches gave different bits")
        ms = timed_ms(lambda: fdk.dc(g, u, v, d1, d2, 300.0), 20)
        plain_ms = timed_ms(
            lambda: fdk.dc_reference(g, u, v, d1, d2, 300.0), 5)
        # the library call: fft2 of g, real part at the entries (ref.py)
        fft_err = float((kref.dc_ref(g, entries, 300.0) - ref[:, :n])
                        .abs().max())
        lib_ms = timed_ms(lambda: kref.dc_ref(g, entries, 300.0), 20)
        flops, direct = fft_ops(d1, d2, L), 4.0 * d1 * d2 * n * L
        nbytes = 4.0 * (L * d1 * d2 + 2 * n + L * n)
        b_ms, b_by = bound(flops, nbytes, "float32")
        print(f"[K2] {d1}x{d2}{how} n={n} L={L}: max_abs_err {err:.3e} = "
              f"{err / scale:.2e} of max |plain| {scale:.3e} (limit "
              f"{REL_TO_PLAIN * scale:.3e}) | kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, fft2 {lib_ms:.3f} ms "
              f"(|fft2 - plain| {fft_err:.1e}), bound {b_ms:.4f} ms "
              f"({b_by}), direct-sum FP32 floor "
              f"{direct / H100_PEAK['float32'] * 1e3:.3f} ms | kernel "
              f"{ms / b_ms:.1f}x its bound, {ms / lib_ms:.2f}x fft2 | "
              "bit-identical on a second launch")
        k2["err"] = max(k2["err"], err)
        if (d1, d2, n, L, main_path) in family_qv + cluster_qv:
            (k2_cluster if how else k2_family).append({
                "d1": d1, "d2": d2, "n": n, "L": L, "max_abs_err": err,
                "max_abs_plain": scale, "limit": REL_TO_PLAIN * scale,
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by})
        if main_path:
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("flops", flops),
                             ("direct_flops", direct), ("bytes", nbytes)):
                k2[key] += val
        del g, out, ref, again
    k2["bound_ms"], k2["bound_by"] = bound(k2["flops"], k2["bytes"],
                                           "float32")
    print(f"[K2] main shapes: kernel {k2['ms']:.3f} ms = "
          f"{k2['ms'] / k2['bound_ms']:.1f}x its bound "
          f"{k2['bound_ms']:.4f} ms, {k2['ms'] / k2['library_ms']:.2f}x "
          f"fft2 ({k2['library_ms']:.3f} ms)")
    if k2["ms"] >= k2["library_ms"]:
        print("[K2] note: not faster than fft2 in this run")

    # ---- 5. K3 ---------------------------------------------------------------
    # yi-6b geometry: H 32, K 4, dh 128, page 16. The first shape is the one
    # PRs 11-15 measured (B 8, W 1, kv_len <= 128: the serving phases'
    # max_len); the others are the contexts users serve: ragged to 1024 and
    # 4096 (one slot at kv_len 1), a full 4096, B 32 at 2048, and a verify
    # window W 5 at 4096. Then group size G = 1 (no GQA: one query row per
    # kv-head and window row, 8x yi-6b's K/V bytes per slot) at LLaMA2-7B's
    # geometry (H = K = 32, dh 128) and GPT-2-medium's (H = K = 16, dh 64),
    # B 8 at kv_len <= 128 and at 4096; and phase 18's MoE serving heads,
    # olmoe-1b-7b (H = K = 16, G = 1) and phi3.5-moe (H 32, K 8, G = 4),
    # dh 128, at the same two contexts. Each in bf16 and f32 against the
    # plain version in f32 on the same inputs, within pak.agreement_limit
    # (f32 atol = rtol = 1e-5; bf16 2e-2 of each output vector's largest
    # |value|, as long contexts make outputs of a few 1e-2), the same bits
    # on a second launch.
    ps, pps = 16, 8
    yi, llama, gpt2m = (32, 4, 128), (32, 32, 128), (16, 16, 64)
    olmoe, phi35 = (16, 16, 128), (32, 8, 128)
    short = [1, 128, 16, 37, 64, 5, 100, 77]
    k3_shapes = (
        ("b8_kv128", 8, 1, 8, short, yi),
        ("b8_ragged1024", 8, 1, 64, [1, 1024, 512, 700, 1000, 33, 257, 900],
         yi),
        ("b8_ragged4096", 8, 1, 256, [1, 4096, 2048, 3000, 4000, 129, 1025,
                                      3500], yi),
        ("b8_kv4096", 8, 1, 256, [4096] * 8, yi),
        ("b32_kv2048", 32, 1, 128, [2048] * 32, yi),
        ("b8_w5_kv4096", 8, 5, 256, [4092] * 8, yi),
        ("llama2_b8_kv128", 8, 1, 8, short, llama),
        ("llama2_b8_kv4096", 8, 1, 256, [4096] * 8, llama),
        ("gpt2m_b8_kv128", 8, 1, 8, short, gpt2m),
        ("gpt2m_b8_kv4096", 8, 1, 256, [4096] * 8, gpt2m),
        ("olmoe_b8_kv128", 8, 1, 8, short, olmoe),
        ("olmoe_b8_kv4096", 8, 1, 256, [4096] * 8, olmoe),
        ("phi35_b8_kv128", 8, 1, 8, short, phi35),
        ("phi35_b8_kv4096", 8, 1, 256, [4096] * 8, phi35),
    )
    from torch.profiler import ProfilerActivity, profile as tprofile

    def device_us(fn, n: int = 20):
        """Device time per call of the K3 kernels (split + combine) from
        torch.profiler; None when the trace shows no device time."""
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        tot = 0.0
        for ev in prof.key_averages():
            if "paged_attn" in ev.key or "combine_splits" in ev.key:
                tot += getattr(ev, "self_device_time_total",
                               getattr(ev, "self_cuda_time_total", 0.0))
        return tot / n if tot > 0 else None

    k3, k3_by_shape = {}, {}
    for sname, B, W, spps, lens, (H, K, dh) in k3_shapes:
        n_pages = B * spps + 2 * spps
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        perm = torch.randperm(n_pages, generator=gen, device=dev)
        bt = perm[:B * spps].reshape(B, spps).to(torch.int32).contiguous()
        k3_by_shape[sname] = {"B": B, "W": W, "pps": spps, "H": H, "K": K,
                              "dh": dh, "kv_len_max": max(lens)}
        for dtype in (torch.bfloat16, torch.float32):
            dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
            q = torch.randn((B, W, H, dh), generator=gen, device=dev).to(dtype)
            elt = torch.finfo(dtype).bits // 8
            pool_bytes = 2 * n_pages * ps * K * dh * elt
            # page pools enough to exceed the 50 MB L2 between launches, as
            # a decode step meets each layer's cache cold
            copies = max(1, min(8, -(-(96 << 20) // pool_bytes)))
            pools = [(torch.randn((n_pages, ps, K, dh), generator=gen,
                                  device=dev).to(dtype),
                      torch.randn((n_pages, ps, K, dh), generator=gen,
                                  device=dev).to(dtype))
                     for _ in range(copies)]
            kp, vp = pools[0]
            plan = pak.launch_plan(q, kp, vp, bt, kv_len)
            out = pak.paged_attention(q, kp, vp, bt, kv_len)
            again = pak.paged_attention(q, kp, vp, bt, kv_len)
            ref = pak.paged_attention_reference(q.float(), kp.float(),
                                                vp.float(), bt, kv_len)
            torch.cuda.synchronize()
            diff = (out.float() - ref).abs()
            err = float(diff.max())
            worst = float((diff / pak.agreement_limit(ref, dtype)).max())
            if not torch.isfinite(out.float()).all() or not worst <= 1.0:
                return fail(f"K3 {sname} {dname}: kernel disagrees with the "
                            f"plain version (max |diff| {err:.3e}, "
                            f"{worst:.3f} of the limit)")
            if not torch.equal(out, again):
                return fail(f"K3 {sname} {dname}: two launches gave "
                            "different bits")
            del out, again, ref
            turn = [0]

            def k3_call():
                kp_, vp_ = pools[turn[0] % copies]
                turn[0] += 1
                return pak.paged_attention(q, kp_, vp_, bt, kv_len)

            ms = timed_ms(k3_call, 100)
            dev_us = device_us(k3_call)
            plain_ms = timed_ms(lambda: pak.paged_attention_reference(
                q, kp, vp, bt, kv_len), 10 if spps > 8 else 100)
            # SDPA over the pre-gathered window (the gather is not timed):
            # GQA through enable_gqa where this torch takes it with a mask,
            # else heads expanded beforehand
            T = spps * ps
            mask = (torch.arange(T, device=dev)[None, None, :]
                    < kv_len[:, None, None]
                    + torch.arange(W, device=dev)[None, :, None])[:, None]
            qg = q.transpose(1, 2).contiguous()               # (B, H, W, dh)
            windows = [(kp_[bt.long()].reshape(B, T, K, dh).transpose(1, 2)
                        .contiguous(),
                        vp_[bt.long()].reshape(B, T, K, dh).transpose(1, 2)
                        .contiguous()) for kp_, vp_ in pools]
            try:
                kg, vg = windows[0]
                F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                               enable_gqa=True)
                sdpa_kw, sdpa_how = {"enable_gqa": True}, "enable_gqa"
            except (RuntimeError, TypeError):
                windows = [(kg.repeat_interleave(H // K, dim=1),
                            vg.repeat_interleave(H // K, dim=1))
                           for kg, vg in windows]
                sdpa_kw, sdpa_how = {}, "expanded heads"
            turn_s = [0]

            def sdpa_call():
                kg_, vg_ = windows[turn_s[0] % copies]
                turn_s[0] += 1
                return F.scaled_dot_product_attention(qg, kg_, vg_,
                                                      attn_mask=mask,
                                                      **sdpa_kw)
            sdpa_ms = timed_ms(sdpa_call, 100)
            del windows
            # the function's bytes: q and out once, the K/V rows each slot's
            # widest row sees, their block-table entries and kv_len; its
            # operations: 4·H·dh per (row, visible column)
            cols = [min(n + W - 1, T) for n in lens]
            nbytes = (2 * B * W * H * dh * elt + 2 * sum(cols) * K * dh * elt
                      + 4 * sum(-(-c // ps) for c in cols) + 4 * B)
            flops = 4.0 * H * dh * sum(max(0, min(n + w, T)) for n in lens
                                       for w in range(W))
            b_ms, b_by = bound(flops, nbytes, dname)
            rec = {"max_abs_err": err, "of_limit": worst, "ms": ms,
                   "device_us": dev_us,
                   "plain_ms": plain_ms, "sdpa_ms": sdpa_ms,
                   "sdpa": sdpa_how, "bound_ms": b_ms, "bound_by": b_by,
                   "splits": plan.splits, "row_groups": plan.row_groups,
                   "pools": copies}
            k3_by_shape[sname][dname] = rec
            dev_txt = (f"{dev_us:.2f} us" if dev_us is not None
                       else "not measured")
            print(f"[K3] {sname} {dname} B={B} W={W} H={H} K={K} dh={dh} "
                  f"kv<={max(lens)} "
                  f"splits={plan.splits} groups={plan.row_groups}: "
                  f"max_abs_err {err:.3e} ({worst:.3f} of the limit) | "
                  f"kernel {ms:.4f} ms (device "
                  f"{dev_txt}), plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} "
                  f"ms ({sdpa_how}), bound {b_ms:.5f} ms ({b_by}) | kernel "
                  f"{ms / b_ms:.1f}x its bound, {ms / sdpa_ms:.2f}x sdpa "
                  f"| bit-identical on a second launch ({copies} pools)")
            if sname == "b8_kv128":
                k3[dname] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                             "library_ms": sdpa_ms, "bound_ms": b_ms,
                             "bound_by": b_by}
            del pools, kp, vp, q
        torch.cuda.empty_cache()
    pps = 8                                  # the serving phases' max_len 128

    # ---- 5b. the fused attention kernel at sft1k's shape ---------------------
    try:
        fused = fused_attention_phase(dev, FUSED_SHAPE, timed_ms,
                                      torch.cuda.synchronize)
    except PhaseError as e:
        return fail(str(e))
    torch.cuda.empty_cache()

    # ---- 6. gradient -------------------------------------------------------------
    from repro_torch.core import adapter as adapter_api
    method = adapter_api.resolve("fourierft")
    grad_peft = PEFTConfig(method="fourierft", n=1000, alpha=300.0)
    before = fdk.dc_launches
    for site_name, d1, d2 in (("layers/wq", 4096, 4096),
                              ("layers/wv", 4096, 512)):
        site = adapter_api.AdapterSite(site_name, d1, d2, 2)
        ad = method.init_site(gen, site, grad_peft, dev)
        g = torch.randn((2, d1, d2), generator=gen, device=dev)
        grads = {}
        for backend in ("auto", "einsum"):
            c = ad["c"].detach().clone().requires_grad_(True)
            dw = method.site_delta({"c": c, "entries": ad["entries"]}, site,
                                   grad_peft.replace(kernel_backend=backend))
            torch.sum(dw * g).backward()
            grads[backend] = c.grad
        if grads["auto"] is None:
            return fail(f"gradient {site_name}: c.grad is None on the card")
        diff = (grads["auto"] - grads["einsum"]).abs()
        if bool((diff > 2e-3 + 1e-4 * grads["einsum"].abs()).any()):
            return fail(f"gradient {site_name}: K2's c.grad differs from the "
                        f"einsum autograd gradient by {float(diff.max()):.3e}")
        print(f"[gradient] {site_name} {d1}x{d2} L=2: c.grad through the "
              f"Function equals the einsum path's within "
              f"{float(diff.max()):.3e} (atol 2e-3, rtol 1e-4)")
    if fdk.dc_launches - before != 2:
        return fail(f"K2 launched {fdk.dc_launches - before} times for two "
                    "sites' backward, expected 2")
    print("[gradient] K2 launched once per site (2)")

    # ---- 7. serve --------------------------------------------------------------
    print(f"[memory] before phase 7: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    cfg = configs.get("yi-6b").replace(num_layers=SLICE_LAYERS)
    print(f"[serve] yi-6b at full width (d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"depth cut 32 -> {cfg.num_layers} layers, {cfg.dtype}")
    peft = PEFTConfig(method="fourierft", n=1000, alpha=300.0)
    model = build(cfg, peft)
    params = model.init(0, dev)
    slots, max_len = 8, pps * ps
    prompts = demo_prompts(cfg, slots)

    def run(backend: str, peft, params):
        m = build(cfg, peft.replace(kernel_backend=backend))
        t0 = time.perf_counter()
        engine = Engine(m, params, batch_slots=slots, max_len=max_len,
                        device=dev)
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t0
        sched = ContinuousScheduler(engine, page_size=ps)
        reqs, arrivals = demo_trace(prompts, 8, 16, 2.0)
        sched.serve(reqs, arrivals)
        torch.cuda.synchronize()
        return engine, sched, reqs, merge_s

    fdk.launches = 0
    pak.launches = 0
    engine, sched, reqs, merge_s = run("auto", peft, params)
    k1_serve, k3_launches = fdk.launches, pak.launches
    steps = sched.metrics.steps
    for i, r in enumerate(reqs):
        if r.out is None or len(r.out) != r.max_new:
            return fail(f"request {i} emitted {r.out!r}, budget {r.max_new}")
    for p in prompts:
        logits = engine.model.forward(engine.params, {"tokens": p[None].to(dev)})
        if logits.shape != (1, p.shape[0], cfg.vocab) \
                or not torch.isfinite(logits.float()).all():
            return fail(f"logits {tuple(logits.shape)} not finite")
    if k1_serve < 1:
        return fail("the merge never launched the ΔW kernel")
    if k3_launches != steps * cfg.num_layers:
        return fail(f"paged attention kernel launched {k3_launches} times, "
                    f"expected {steps} decode steps x {cfg.num_layers}")
    s = sched.metrics.summary()
    print(f"[serve] kernels: merge {merge_s:.3f} s, {len(reqs)} requests, "
          f"{s['total_tokens']:.0f} tokens in {steps} decode steps | "
          f"{s['tokens_per_s']:.1f} tok/s, ttft {s['ttft_steps_mean']:.2f} "
          f"steps (p90 {s['ttft_steps_p90']:.0f}), prime "
          f"{s['prime_s_mean'] * 1e3:.2f} ms mean | K1 launches "
          f"{k1_serve}, K3 launches {k3_launches}")
    engine_e, sched_e, reqs_e, merge_e = run("einsum", peft, params)
    for key in ("wq", "wv"):
        # the f32 ΔWs agree to ~1e-8 (phase 3); see merged_within_one_ulp
        w = params["base"]["layers"][key]
        ok, ndiff = merged_within_one_ulp(
            w, engine.params["base"]["layers"][key],
            engine_e.params["base"]["layers"][key])
        if not ok:
            return fail(f"merged {key}: kernel and plain merges differ by "
                        "more than one bf16 ulp")
        print(f"[serve] merged {key}: {ndiff} of {w.numel()} bf16 values "
              "differ (each within one ulp)")
    first = [r.out[0] for r in reqs] == [r.out[0] for r in reqs_e]
    later = sum(x != y for r, re_ in zip(reqs, reqs_e)
                for x, y in zip(r.out[1:], re_.out[1:]))
    if not first:
        return fail("first tokens differ between the kernel and plain runs")
    s_e = sched_e.metrics.summary()
    print(f"[serve] plain (einsum): merge {merge_e:.3f} s, "
          f"{s_e['tokens_per_s']:.1f} tok/s | merged wq/wv within one bf16 "
          f"ulp, first tokens equal, {later} later token mismatches of "
          f"{sum(len(r.out) - 1 for r in reqs)}")
    # the first run above also paid one-time set-up (library handles,
    # pinned buffers); a second kernel run, after the plain one, is the
    # warm figure to compare with it
    engine_w, sched_w, reqs_w, merge_w = run("auto", peft, params)
    s_w = sched_w.metrics.summary()
    print(f"[serve] kernels, warm: merge {merge_w:.3f} s, "
          f"{s_w['tokens_per_s']:.1f} tok/s, prime "
          f"{s_w['prime_s_mean'] * 1e3:.2f} ms mean, streams "
          f"{'equal' if [r.out for r in reqs_w] == [r.out for r in reqs] else 'DIFFER'}")

    del engine, sched, engine_e, sched_e, engine_w, sched_w, params

    # ---- 8. train --------------------------------------------------------------
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.train import step as train_step
    tcfg = TrainConfig(learning_rate=1e-2, total_steps=TRAIN_STEPS,
                       warmup_steps=1, microbatch=MICROBATCH)
    B, S = 8, 64
    data = SyntheticLM(vocab=cfg.vocab, batch=B, seq=S, seed=0, task_seed=7)
    batches = [{k: t.to(dev) for k, t in data.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    print(f"[train] yi-6b full width, {cfg.num_layers} layers, {cfg.dtype}; "
          f"FourierFT n {peft.n} alpha {peft.alpha:g} on wq/wv; batch {B} x "
          f"seq {S}, microbatch {MICROBATCH}, {TRAIN_STEPS} steps, lr "
          f"{tcfg.learning_rate:g}, warmup {tcfg.warmup_steps}")

    def train(backend: str):
        m = build(cfg, peft.replace(kernel_backend=backend))
        state, frozen = train_step.init_state(m, tcfg, 0, dev)
        c0 = {k: ad["c"].clone()
              for k, ad in state["trainable"]["peft"].items()}
        step = train_step.make_train_step(m, tcfg)
        losses, secs = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, frozen, b)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        c1 = {k: ad["c"] for k, ad in state["trainable"]["peft"].items()}
        return state, c0, c1, losses, secs

    torch.cuda.reset_peak_memory_stats()
    fdk.launches = fdk.dc_launches = 0
    fak.launches = fak.bwd_launches = 0
    state, c0, c1, losses, secs = train("auto")
    k1_train, k2_train = fdk.launches, fdk.dc_launches
    fa_train = (fak.launches, fak.bwd_launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = TRAIN_STEPS * MICROBATCH * 2
    if not all(math.isfinite(x) for x in losses):
        return fail(f"train: non-finite loss {losses}")
    if int(state["anomalies"]) != 0:
        return fail(f"train: {int(state['anomalies'])} anomalous steps")
    if all(torch.equal(c0[k], c1[k]) for k in c0):
        return fail("train: the coefficients never moved")
    if k1_train != expected or k2_train != expected:
        return fail(f"train: K1 launched {k1_train}, K2 {k2_train} times; "
                    f"expected {TRAIN_STEPS} steps x {MICROBATCH} "
                    f"microbatches x 2 sites = {expected} each")
    # bf16 at S <= 1024: attention through the fused kernel, forward and
    # backward once a layer a microbatch (no remat)
    fa_expected = TRAIN_STEPS * MICROBATCH * cfg.num_layers
    if fa_train != (fa_expected, fa_expected):
        return fail(f"train: the fused attention kernel launched "
                    f"{fa_train[0]} forward, {fa_train[1]} backward; "
                    f"expected {TRAIN_STEPS} steps x {MICROBATCH} "
                    f"microbatches x {cfg.num_layers} layers = "
                    f"{fa_expected} each")
    warm_ms = 1e3 * sum(secs[1:]) / len(secs[1:])
    print(f"[train] kernels: losses {[round(x, 4) for x in losses]} | K1 "
          f"launches {k1_train}, K2 launches {k2_train}, fused attention "
          f"{fa_train[0]} + {fa_train[1]} backward | cold step "
          f"{secs[0] * 1e3:.1f} ms ({B * S / secs[0]:.0f} tokens/s), warm "
          f"{warm_ms:.1f} ms/step ({B * S / warm_ms * 1e3:.0f} tokens/s) | "
          f"peak device memory {peak_gib:.2f} GiB")
    del state
    fdk.launches = fdk.dc_launches = 0
    state_e, c0_e, c1_e, losses_e, secs_e = train("einsum")
    if fdk.launches or fdk.dc_launches:
        return fail("train: the einsum run launched a kernel")
    # Tolerances against the plain (einsum) run, each with the reading it
    # was set from (read on an NVIDIA H100 80GB HBM3 at 700 W). Both runs
    # add bf16(ΔW) to the same bf16 W; the f32 ΔWs (1e-8 apart, phase 3)
    # round to bf16 on opposite sides for a few hundred weights, and the
    # bf16 model turns that into bf16-ulp noise in every later activation.
    # - per-step losses: 5e-3 (read: 1.47e-3 at most over the 6 steps);
    # - the coefficients' movement Δc = c_final - c0 of the two runs,
    #   ||Δc_kernel - Δc_einsum|| / ||Δc_einsum||: 0.2 (read: 5.45e-2; Adam
    #   gives a coefficient whose gradient sits near zero a full-size step
    #   whose sign that noise can flip). A K2 of the wrong sign moves c the
    #   other way (about 2); Adam hides a wrong scale, which the check below
    #   catches.
    dloss = max(abs(x - y) for x, y in zip(losses, losses_e))
    dc_k = torch.cat([(c1[k] - c0[k]).flatten() for k in c1])
    dc_e = torch.cat([(c1_e[k] - c0_e[k]).flatten() for k in c1])
    dc_rel = float((dc_k - dc_e).norm() / dc_e.norm())
    print(f"[train] plain (einsum): losses {[round(x, 4) for x in losses_e]}"
          f", warm {1e3 * sum(secs_e[1:]) / len(secs_e[1:]):.1f} ms/step | "
          f"max |loss diff| {dloss:.2e} (limit 5e-3) | Δc rel diff "
          f"{dc_rel:.2e} (limit 0.2)")
    if dloss > 5e-3 or dc_rel > 0.2:
        return fail("train: the kernel and einsum runs drifted apart beyond "
                    "the stated tolerances")
    del state_e, c0, c1, c0_e, c1_e

    # The whole model's gradient w.r.t. c at the initial state and the first
    # batch, kernel path against einsum path, with the same model in f32
    # (TF32 off), where the two differ only by K1's and K2's own f32
    # rounding. Unlike the Adam steps it keeps the gradient's scale and
    # sign. Limits: relative difference 1e-4 (read: 3.19e-6; the bf16 model
    # gives 1.14e-2 here, its ulp noise amplified by the cancellation in a
    # sum over d1·d2 terms), and the same sign for every coefficient whose
    # gradient is above 1 % of the largest (read: 0 of 2762). Run after the
    # counted runs, so its launches are not counted.
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")

    def grad0(backend: str):
        m = build(cfg32, peft.replace(kernel_backend=backend))
        st, frozen = train_step.init_state(m, tcfg, 0, dev)
        cs = [ad["c"].requires_grad_(True)
              for ad in st["trainable"]["peft"].values()]
        loss = m.loss_from_parts(st["trainable"], frozen["base"],
                                 frozen["peft"], batches[0])
        return torch.cat([g.flatten()
                          for g in torch.autograd.grad(loss, cs)])
    g_k, g_e = grad0("auto"), grad0("einsum")
    g_rel = float((g_k - g_e).norm() / g_e.norm())
    strong = g_e.abs() > 1e-2 * g_e.abs().max()
    flips = int((strong & (torch.sign(g_k) != torch.sign(g_e))).sum())
    print(f"[train] first-batch gradient in f32, kernel vs einsum: |g| "
          f"median {float(g_e.abs().median()):.2e}, max "
          f"{float(g_e.abs().max()):.2e}; rel diff {g_rel:.2e} (limit 1e-4); "
          f"sign differs on {flips} of {int(strong.sum())} coefficients "
          f"above 1 % of the max (limit 0)")
    if g_rel > 1e-4 or flips:
        return fail("train: the f32 first-batch gradient through K2 differs "
                    "from the einsum path's beyond the stated tolerances")

    # ---- 9. K4 -----------------------------------------------------------------
    def dct_inputs(d1, d2, n, L):
        entries = sample_entries(d1, d2, n, seed=7).to(dev)
        u, v = padded_entries(entries, n, ddk.NC)
        c = torch.zeros((L, u.shape[0]), dtype=torch.float32, device=dev)
        c[:, :n] = torch.randn((L, n), generator=gen, device=dev)
        c1, c2 = dct_bases(torch.stack([u, v]), d1, d2)
        return u, v, c, c1, c2

    k4 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "err": 0.0,
          "flops": 0.0, "direct_flops": 0.0, "bytes": 0.0}
    k4_cluster, k5_cluster = [], []
    for d1, d2, n, L, main_path in shapes + cluster_qv:
        u, v, c, c1, c2 = dct_inputs(d1, d2, n, L)
        try:
            how = cluster_checked("K4", d1, d2, u.shape[0])
        except PhaseError as e:
            return fail(str(e))
        out = ddk.deltaw(c, u, v, d1, d2, 300.0)
        ref = ddk.deltaw_reference(c, u, v, d1, d2, 300.0)
        again = ddk.deltaw(c, u, v, d1, d2, 300.0)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = float(diff.max())
        scale = float(ref.abs().max())
        if not torch.isfinite(out).all() or bool(
                (diff > 2e-5 + 1e-5 * ref.abs()).any()) \
                or err > REL_TO_PLAIN * scale:
            return fail(f"K4 {d1}x{d2} n={n} L={L}: max |kernel - plain| "
                        f"{err:.3e} beyond atol 2e-5, rtol 1e-5, or "
                        f"{REL_TO_PLAIN} of max |plain| {scale:.3e}")
        if not torch.equal(out, again):
            return fail(f"K4 {d1}x{d2}: two launches gave different bits")
        ms = timed_ms(lambda: ddk.deltaw(c, u, v, d1, d2, 300.0), 20)
        plain_ms = timed_ms(
            lambda: ddk.deltaw_reference(c, u, v, d1, d2, 300.0), 5)
        # the library call: one torch.matmul of the prebuilt rank-n factors
        a = c1[None] * c[:, None, :] * (300.0 / (d1 * d2))
        b = c2.T.contiguous()
        lib_err = float((torch.matmul(a, b) - ref).abs().max())
        lib_ms = timed_ms(lambda: torch.matmul(a, b), 5)
        flops, direct = fft_ops(d1, d2, L), 2.0 * d1 * d2 * n * L
        nbytes = 4.0 * (L * n + 2 * n + L * d1 * d2)
        b_ms, b_by = bound(flops, nbytes, "float32")
        print(f"[K4] {d1}x{d2}{how} n={n} L={L}: max_abs_err {err:.3e} = "
              f"{err / scale:.2e} of max |plain| {scale:.3e} (limit "
              f"{REL_TO_PLAIN * scale:.3e}) | "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, matmul "
              f"{lib_ms:.3f} ms "
              f"(|matmul - plain| {lib_err:.1e}), bound {b_ms:.4f} ms "
              f"({b_by}), direct-sum FP32 floor "
              f"{direct / H100_PEAK['float32'] * 1e3:.3f} ms | kernel "
              f"{ms / b_ms:.1f}x its bound, {ms / lib_ms:.2f}x matmul | "
              "bit-identical on a second launch")
        k4["err"] = max(k4["err"], err)
        if how:
            k4_cluster.append({"d1": d1, "d2": d2, "n": n, "L": L,
                               "max_abs_err": err, "max_abs_plain": scale,
                               "limit": REL_TO_PLAIN * scale, "ms": ms,
                               "plain_ms": plain_ms, "library_ms": lib_ms,
                               "bound_ms": b_ms, "bound_by": b_by})
        if main_path:
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("flops", flops),
                             ("direct_flops", direct), ("bytes", nbytes)):
                k4[key] += val
        del a, b, out, ref, again, c1, c2
    k4["bound_ms"], k4["bound_by"] = bound(k4["flops"], k4["bytes"],
                                           "float32")
    print(f"[K4] main shapes: kernel {k4['ms']:.3f} ms = "
          f"{k4['ms'] / k4['bound_ms']:.1f}x its bound "
          f"{k4['bound_ms']:.4f} ms, {k4['ms'] / k4['library_ms']:.2f}x "
          f"matmul ({k4['library_ms']:.3f} ms)")
    if k4["ms"] >= k4["library_ms"]:
        print("[K4] note: not faster than the matmul in this run")

    # ---- 10. K5 ----------------------------------------------------------------
    k5 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "err": 0.0,
          "flops": 0.0, "direct_flops": 0.0, "bytes": 0.0}
    for d1, d2, n, L, main_path in shapes + cluster_qv:
        u, v, _, c1, c2 = dct_inputs(d1, d2, n, L)
        try:
            how = cluster_checked("K5", d1, d2, u.shape[0])
        except PhaseError as e:
            return fail(str(e))
        g = torch.randn((L, d1, d2), generator=gen, device=dev)
        out = ddk.dc(g, u, v, d1, d2, 300.0)
        ref = ddk.dc_reference(g, u, v, d1, d2, 300.0)
        again = ddk.dc(g, u, v, d1, d2, 300.0)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = float(diff.max())
        ref_max = float(ref.abs().max())
        if not torch.isfinite(out).all() or bool(
                (diff > 1e-4 + 1e-3 * ref.abs()).any()) \
                or err > REL_TO_PLAIN * ref_max:
            return fail(f"K5 {d1}x{d2} n={n} L={L}: max |kernel - plain| "
                        f"{err:.3e} beyond atol 1e-4, rtol 1e-3, or "
                        f"{REL_TO_PLAIN} of max |plain| {ref_max:.3e}")
        if not torch.equal(out, again):
            return fail(f"K5 {d1}x{d2}: two launches gave different bits")
        ms = timed_ms(lambda: ddk.dc(g, u, v, d1, d2, 300.0), 20)
        plain_ms = timed_ms(
            lambda: ddk.dc_reference(g, u, v, d1, d2, 300.0), 5)
        # the library call: torch.matmul(g, C2) on the prebuilt bases, then
        # the C1-weighted sum over rows
        scale = 300.0 / (d1 * d2)
        lib_ms = timed_ms(
            lambda: (torch.matmul(g, c2) * c1).sum(dim=-2) * scale, 5)
        flops, direct = fft_ops(d1, d2, L), 2.0 * d1 * d2 * n * L
        nbytes = 4.0 * (L * d1 * d2 + 2 * n + L * n)
        b_ms, b_by = bound(flops, nbytes, "float32")
        print(f"[K5] {d1}x{d2}{how} n={n} L={L}: max_abs_err {err:.3e} = "
              f"{err / ref_max:.2e} of max |plain| {ref_max:.3e} (limit "
              f"{REL_TO_PLAIN * ref_max:.3e}) | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, matmul(g, C2) "
              f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), direct-sum "
              f"FP32 floor {direct / H100_PEAK['float32'] * 1e3:.3f} ms | "
              f"kernel {ms / b_ms:.1f}x its bound, {ms / lib_ms:.2f}x "
              "matmul | bit-identical on a second launch")
        k5["err"] = max(k5["err"], err)
        if how:
            k5_cluster.append({"d1": d1, "d2": d2, "n": n, "L": L,
                               "max_abs_err": err, "max_abs_plain": ref_max,
                               "limit": REL_TO_PLAIN * ref_max, "ms": ms,
                               "plain_ms": plain_ms, "library_ms": lib_ms,
                               "bound_ms": b_ms, "bound_by": b_by})
        if main_path:
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("flops", flops),
                             ("direct_flops", direct), ("bytes", nbytes)):
                k5[key] += val
        del g, out, ref, again, c1, c2
    k5["bound_ms"], k5["bound_by"] = bound(k5["flops"], k5["bytes"],
                                           "float32")
    print(f"[K5] main shapes: kernel {k5['ms']:.3f} ms = "
          f"{k5['ms'] / k5['bound_ms']:.1f}x its bound "
          f"{k5['bound_ms']:.4f} ms, {k5['ms'] / k5['library_ms']:.2f}x "
          f"matmul(g, C2) ({k5['library_ms']:.3f} ms)")
    if k5["ms"] >= k5["library_ms"]:
        print("[K5] note: not faster than matmul(g, C2) in this run")

    # ---- 11. dct gradient -------------------------------------------------------
    dct = adapter_api.resolve("dct")
    dpeft = PEFTConfig(method="dct", n=1000, alpha=300.0)
    before = ddk.dc_launches
    for site_name, d1, d2 in (("layers/wq", 4096, 4096),
                              ("layers/wv", 4096, 512)):
        site = adapter_api.AdapterSite(site_name, d1, d2, 2)
        ad = dct.init_site(gen, site, dpeft, dev)
        g = torch.randn((2, d1, d2), generator=gen, device=dev)
        grads = {}
        for backend in ("auto", "einsum"):
            c = ad["c"].detach().clone().requires_grad_(True)
            dw = dct.site_delta({"c": c, "entries": ad["entries"]}, site,
                                dpeft.replace(kernel_backend=backend))
            torch.sum(dw * g).backward()
            grads[backend] = c.grad
        if grads["auto"] is None:
            return fail(f"dct gradient {site_name}: c.grad is None on the "
                        "card")
        diff = (grads["auto"] - grads["einsum"]).abs()
        if bool((diff > 1e-4 + 1e-3 * grads["einsum"].abs()).any()):
            return fail(f"dct gradient {site_name}: K5's c.grad differs from "
                        f"the einsum autograd gradient by "
                        f"{float(diff.max()):.3e}")
        print(f"[dct gradient] {site_name} {d1}x{d2} L=2: c.grad through the "
              f"Function equals the einsum path's within "
              f"{float(diff.max()):.3e} (atol 1e-4, rtol 1e-3)")
    if ddk.dc_launches - before != 2:
        return fail(f"K5 launched {ddk.dc_launches - before} times for two "
                    "sites' backward, expected 2")
    print("[dct gradient] K5 launched once per site (2)")

    # ---- 12. dct: train, merge, serve --------------------------------------------
    print(f"[memory] before phase 12: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    print(f"[dct] yi-6b full width, {cfg.num_layers} layers, {cfg.dtype}; "
          f"dct n {dpeft.n} alpha {dpeft.alpha:g} on wq/wv; {TRAIN_STEPS} "
          f"steps of phase 8's batches (microbatch {MICROBATCH}), then the "
          "launcher's 8-request trace")
    ddk.launches = ddk.dc_launches = 0
    dmodel = build(cfg, dpeft)
    state, frozen = train_step.init_state(dmodel, tcfg, 0, dev)
    c0 = {k: ad["c"].clone() for k, ad in state["trainable"]["peft"].items()}
    step = train_step.make_train_step(dmodel, tcfg)
    losses, secs = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, frozen, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    k4_train, k5_train = ddk.launches, ddk.dc_launches
    if not all(math.isfinite(x) for x in losses):
        return fail(f"dct train: non-finite loss {losses}")
    if int(state["anomalies"]) != 0:
        return fail(f"dct train: {int(state['anomalies'])} anomalous steps")
    if all(torch.equal(c0[k], ad["c"])
           for k, ad in state["trainable"]["peft"].items()):
        return fail("dct train: the coefficients never moved")
    if k4_train != expected or k5_train != expected:
        return fail(f"dct train: K4 launched {k4_train}, K5 {k5_train} "
                    f"times; expected {TRAIN_STEPS} steps x {MICROBATCH} "
                    f"microbatches x 2 sites = {expected} each")
    dwarm = 1e3 * sum(secs[1:]) / len(secs[1:])
    print(f"[dct] train: losses {[round(x, 4) for x in losses]} | K4 "
          f"launches {k4_train}, K5 launches {k5_train} | cold step "
          f"{secs[0] * 1e3:.1f} ms, warm {dwarm:.1f} ms/step "
          f"({B * S / dwarm * 1e3:.0f} tokens/s)")
    dparams = train_step.join_params(dmodel, state["trainable"], frozen)
    del state, frozen, c0
    ddk.launches = 0
    pak.launches = 0
    engine, sched, reqs, merge_s = run("auto", dpeft, dparams)
    k4_serve, k3_dct = ddk.launches, pak.launches
    steps = sched.metrics.steps
    for i, r in enumerate(reqs):
        if r.out is None or len(r.out) != r.max_new:
            return fail(f"dct request {i} emitted {r.out!r}, budget "
                        f"{r.max_new}")
    if k4_serve != 2:
        return fail(f"the dct merge launched K4 {k4_serve} times, expected "
                    "one per site (2)")
    if k3_dct != steps * cfg.num_layers:
        return fail(f"dct serve: K3 launched {k3_dct} times, expected "
                    f"{steps} decode steps x {cfg.num_layers}")
    s = sched.metrics.summary()
    engine_e, sched_e, reqs_e, merge_e = run("einsum", dpeft, dparams)
    for key in ("wq", "wv"):
        w = dparams["base"]["layers"][key]
        ok, ndiff = merged_within_one_ulp(
            w, engine.params["base"]["layers"][key],
            engine_e.params["base"]["layers"][key])
        if not ok:
            return fail(f"dct merged {key}: kernel and plain merges differ "
                        "by more than one bf16 ulp")
        print(f"[dct] merged {key}: {ndiff} of {w.numel()} bf16 values "
              "differ (each within one ulp)")
    later = sum(x != y for r, re_ in zip(reqs, reqs_e)
                for x, y in zip(r.out[1:], re_.out[1:]))
    print(f"[dct] serve: merge {merge_s:.3f} s (plain {merge_e:.3f} s), "
          f"{len(reqs)} requests, {s['total_tokens']:.0f} tokens in {steps} "
          f"decode steps, {s['tokens_per_s']:.1f} tok/s | K4 launches "
          f"{k4_serve}, K3 launches {k3_dct} | {later} later token "
          f"mismatches of {sum(len(r.out) - 1 for r in reqs)} against the "
          "einsum merge's run")

    @torch.no_grad()
    def first_logits(engine):
        """f32 logits after each prompt's last token: request i's first
        token is their argmax (greedy), (len(prompts), vocab)."""
        return torch.stack([engine.model.forward(
            engine.params, {"tokens": p[None].to(dev)})[0, -1].float()
            for p in prompts])

    # bf16: the two merges differ in one-ulp roundings of a few hundred
    # weights (above); how far that moves the first-position logits, and
    # how close each request's top two tokens are
    lk, le = first_logits(engine), first_logits(engine_e)
    top2 = le.topk(2, dim=-1).values
    flips = [i for i, (r, re_) in enumerate(zip(reqs, reqs_e))
             if r.out[0] != re_.out[0]]
    print(f"[dct] bf16 first tokens: {len(reqs) - len(flips)} of "
          f"{len(reqs)} equal (differ: requests {flips}); max |logits "
          f"kernel - einsum| at the first position "
          f"{float((lk - le).abs().max()):.3e}; einsum top-2 margins "
          f"{[round(float(m), 4) for m in top2[:, 0] - top2[:, 1]]}")
    del engine, sched, engine_e, sched_e, lk, le
    # f32: the same trained coefficients merged into the f32 model, where
    # the two merges differ only by K4's own rounding (~1e-9, phase 9):
    # every request's first token must be the same
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                   dparams)
    del dparams
    first32 = {}
    for backend in ("auto", "einsum"):
        eng = Engine(build(cfg32, dpeft.replace(kernel_backend=backend)),
                     p32, batch_slots=slots, max_len=max_len, device=dev)
        first32[backend] = first_logits(eng)
        del eng
    d32 = float((first32["auto"] - first32["einsum"]).abs().max())
    same = torch.equal(first32["auto"].argmax(-1),
                       first32["einsum"].argmax(-1))
    top2 = first32["einsum"].topk(2, dim=-1).values
    print(f"[dct] f32 merge: first tokens {'equal' if same else 'DIFFER'} "
          f"for all {len(prompts)} prompts; max |logits kernel - einsum| "
          f"{d32:.3e}; smallest einsum top-2 margin "
          f"{float((top2[:, 0] - top2[:, 1]).min()):.3e}")
    if not same:
        return fail("dct: f32 first tokens differ between the kernel and "
                    "plain merges")
    del p32, first32

    # ---- 13. bank: multi-tenant serving over the clean base ----------------------
    print(f"[memory] before phase 13: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    try:
        k3_bank = bank_phase(dev, cfg, prompts, slots, max_len, ps, pps, gen,
                             (SLICE_LAYERS, 32))
    except PhaseError as e:
        return fail(str(e))

    # ---- 14. spec: speculative decoding and the dense per-slot cache -------
    print(f"[memory] before phase 14: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    try:
        k3_spec, k3_spec_err = spec_phase(dev, cfg, prompts, slots,
                                          max_len, ps, pps,
                                          (SLICE_LAYERS, 32))
    except PhaseError as e:
        return fail(str(e))
    print(f"[memory] after phase 14: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")

    # ---- 16. paper: the paper's models, Table 1, the bases, full, factored --
    torch.cuda.empty_cache()
    try:
        paper = paper_phase(dev, {"llama": configs.get("llama2-7b"),
                                  "roberta": configs.get("roberta-base"),
                                  "gpt2": configs.get("gpt2-medium"),
                                  "factored": cfg},
                            prompts, slots, max_len, ps, pps)
    except PhaseError as e:
        return fail(str(e))

    # ---- 17. tiering: preempt and resume, host tiers, the gateway ----------
    torch.cuda.empty_cache()
    print(f"[memory] before phase 17: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    try:
        tiering = tiering_phase(dev, cfg, ps, torch.cuda.synchronize)
    except PhaseError as e:
        return fail(str(e))

    # ---- 18. families and long sequences -----------------------------------
    torch.cuda.empty_cache()
    print(f"[memory] before phase 18: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    olmoe_cfg = configs.get("olmoe-1b-7b")
    try:
        fam = families_phase(
            dev, {"olmoe": olmoe_cfg,
                  "olmoe2": olmoe_cfg.replace(num_layers=2, dtype="float32",
                                              param_dtype="float32"),
                  "phi": configs.get("phi3.5-moe-42b-a6.6b").replace(
                      num_layers=4),
                  "musicgen": configs.get("musicgen-medium"),
                  "qwen2vl": configs.get("qwen2-vl-72b").replace(
                      num_layers=2)},
            {"attn": (32, 4, 128, 4096), "olmoe": (1, 4096),
             "phi": (1, 2048), "musicgen": (2, 2048), "qwen2vl": (1, 2048)},
            timed_ms, torch.cuda.synchronize)
    except PhaseError as e:
        return fail(str(e))
    fl = fam["launches"]
    fam_k1_train = sum(v_["K1"] for k_, v_ in fl.items()
                       if k_.endswith("_train"))
    fam_k2_train = sum(v_["K2"] for k_, v_ in fl.items()
                       if k_.endswith("_train"))
    fam_k1_merge = sum(v_.get("K1", 0) for k_, v_ in fl.items()
                       if not k_.endswith("_train"))
    # 18e's launches over a cluster of two blocks (wi, 8192 x 29568)
    fam_cluster = {
        "K1": {"train": fl["qwen2vl_train"]["K1c"],
               "merge": fl["qwen2vl_merge"]["K1c"]},
        "K2": {"train": fl["qwen2vl_train"]["K2c"]},
        "K4": {"train": fl["qwen2vl_dct_train"]["K4c"],
               "merge": fl["qwen2vl_dct_merge"]["K4c"]},
        "K5": {"train": fl["qwen2vl_dct_train"]["K5c"]}}
    fam_k3 = sum(v_.get("K3", 0) for k_, v_ in fl.items()
                 if k_.endswith("_serve"))

    # ---- 19. ssm: the pure-SSM and hybrid families ---------------------------
    torch.cuda.empty_cache()
    print(f"[memory] before phase 19: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    zamba_cfg = configs.get("zamba2-7b")
    try:
        ssm = ssm_phase(
            dev, {"mamba": configs.get("mamba2-2.7b"),
                  "mamba_f32": configs.get("mamba2-2.7b").replace(
                      num_layers=2, dtype="float32", param_dtype="float32"),
                  "zamba": zamba_cfg,
                  "zamba_f32": zamba_cfg.replace(
                      num_layers=zamba_cfg.zamba.shared_every + 1,
                      dtype="float32", param_dtype="float32")},
            {"scan": (80, 64, 128, 1, 256, 1, 4096),
             "scan_pack4k": (112, 64, 64, 2, 256, 1, 4096),
             "mamba": (1, 2048),
             "zamba": (1, 2048), "decode_len": 4096},
            timed_ms, torch.cuda.synchronize)
    except PhaseError as e:
        return fail(str(e))
    sl = ssm["launches"]

    # ---- 20. analysis: the audit, the dispatch lint and --analyze ----------
    torch.cuda.empty_cache()
    print(f"[memory] before phase 20: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    try:
        ana = analysis_phase(
            dev, {"train": configs.get("yi-6b").replace(
                num_layers=SLICE_LAYERS), "serve": configs.get("yi-6b")},
            {"train": (2, 64, 3), "serve": (slots, max_len, ps, 8, 16, 2.0)},
            torch.cuda.synchronize, torch.cuda.set_sync_debug_mode,
            ["--arch", "yi-6b", "--continuous", "--analyze"])
    except PhaseError as e:
        return fail(str(e))
    al = ana["launches"]["analysis"]

    # ---- 21. mesh: the placement layer and the sharded paths ---------------
    torch.cuda.empty_cache()
    print(f"[memory] before phase 21: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    try:
        mesh = mesh_phase(dev, configs.get("yi-6b"))
    except PhaseError as e:
        return fail(str(e))
    mk = {**mesh["train"]["launches"], "K3": mesh["serve"]["launches"]["K3"],
          "K1_merge": mesh["serve"]["launches"]["K1"],
          "K1_mb": mesh["train_microbatch"]["launches"]["K1"],
          "K2_mb": mesh["train_microbatch"]["launches"]["K2"]}

    # ---- 22. families mesh: every family, the bank and the gateway -------
    torch.cuda.empty_cache()
    print(f"[memory] before phase 22: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    try:
        fm = families_mesh_phase(dev, cfg)
    except PhaseError as e:
        return fail(str(e))
    fk = {"K1": fm["olmoe"]["launches"]["K1"]
          + fm["mamba2"]["launches"]["K1"],
          "K2": fm["olmoe"]["launches"]["K2"]
          + fm["mamba2"]["launches"]["K2"],
          "K3": fm["olmoe"]["serve_launches"]["K3"]}

    # ---- 23. entry points: the load harness and the examples --------------
    torch.cuda.empty_cache()
    print(f"[memory] before phase 23: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    try:
        entry = entry_points_phase(dev, Path(__file__).resolve().parent
                                   / "build" / "entry")
    except PhaseError as e:
        return fail(str(e))
    ek = entry["launches"]

    # ---- 15. kernels line (printed last) ------------------------------------
    kb = k3["bfloat16"]
    print(json.dumps({"kernels": [
        {"name": "fourier_deltaw", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fourier_deltaw.cu",
         "replaces": "src/repro/kernels/fourier_deltaw.py:86",
         "launches": k1_train,
         "launches_by_path": {"train": k1_train, "serve": k1_serve,
                              "paper_train": paper["llama_train"]["K1"],
                              "paper_merge": paper["llama_serve"]["K1"],
                              "tiering_merge": tiering["k1_merge"],
                              "families_train": fam_k1_train,
                              "families_merge": fam_k1_merge,
                              "ssm_train": sl["ssm_train"]["K1"],
                              "ssm_merge": sl["ssm_merge"]["K1"],
                              "hybrid_train": sl["hybrid_train"]["K1"],
                              "hybrid_merge": sl["hybrid_merge"]["K1"],
                              "analysis": al["K1"],
                              "mesh_train": mk["K1"],
                              "mesh_microbatch_train": mk["K1_mb"],
                              "mesh_merge": mk["K1_merge"],
                              "families_mesh_train": fk["K1"],
                              "examples": ek["examples"]["K1"],
                              "cluster_train": fam_cluster["K1"]["train"],
                              "cluster_merge": fam_cluster["K1"]["merge"]},
         "family_shapes": k1_family, "cluster_shapes": k1_cluster,
         "max_abs_err": k1["err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"], "library_call": "torch.fft.ifft2",
         "matmul_ms": k1["matmul_ms"],
         "direct_sum_bound_ms": k1["direct_flops"] / H100_PEAK["float32"]
         * 1e3},
        {"name": "fourier_dc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fourier_deltaw.cu",
         "replaces": "src/repro/kernels/fourier_deltaw.py:130",
         "launches": k2_train,
         "launches_by_path": {"train": k2_train,
                              "paper_train": paper["llama_train"]["K2"],
                              "families_train": fam_k2_train,
                              "ssm_train": sl["ssm_train"]["K2"],
                              "hybrid_train": sl["hybrid_train"]["K2"],
                              "analysis": al["K2"],
                              "mesh_train": mk["K2"],
                              "mesh_microbatch_train": mk["K2_mb"],
                              "families_mesh_train": fk["K2"],
                              "examples": ek["examples"]["K2"],
                              "cluster_train": fam_cluster["K2"]["train"]},
         "family_shapes": k2_family, "cluster_shapes": k2_cluster,
         "max_abs_err": k2["err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"], "library_call": "torch.fft.fft2",
         "direct_sum_bound_ms": k2["direct_flops"] / H100_PEAK["float32"]
         * 1e3},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:149",
         "launches": k3_launches,
         "max_abs_err": max([v["err"] for v in k3.values()]
                            + [k3_spec_err]),
         "ms": kb["ms"], "plain_ms": kb["plain_ms"],
         "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"],
         "library_ms": kb["library_ms"],
         "library_call": "torch.nn.functional.scaled_dot_product_attention",
         "launches_by_path": {"serve": k3_launches, "dct_serve": k3_dct,
                              "bank_serve": k3_bank, **k3_spec,
                              "paper_serve": paper["llama_serve"]["K3"],
                              "tiering_serve": sum(
                                  n for k_, n in tiering["k3"].items()
                                  if k_ != "gateway"),
                              "gateway_serve": tiering["k3"]["gateway"],
                              "families_serve": fam_k3,
                              "analysis": al["K3"],
                              "mesh_serve": mk["K3"],
                              "families_mesh_serve": fk["K3"],
                              "entry_replay": ek["replay"]["K3"],
                              "examples": ek["examples"]["K3"]},
         "design": "split-KV over pages (flash-decoding), cp.async ring of "
                   "two chunks, mma.sync bf16 / FP32 FMA, fixed-order "
                   "combine",
         "ms_by_shape": k3_by_shape},
        {"name": "dct_deltaw", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dct_deltaw.cu",
         "replaces": "src/repro/kernels/dct_deltaw.py:73",
         "launches": k4_train,
         "launches_by_path": {"train": k4_train, "serve": k4_serve,
                              "qwen2vl_dct_train":
                                  fl["qwen2vl_dct_train"]["K4"],
                              "qwen2vl_dct_merge":
                                  fl["qwen2vl_dct_merge"]["K4"],
                              "cluster_train": fam_cluster["K4"]["train"],
                              "cluster_merge": fam_cluster["K4"]["merge"]},
         "cluster_shapes": k4_cluster,
         "max_abs_err": k4["err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": k4["library_ms"],
         "library_call": "torch.matmul of prebuilt (C1*c), C2^T",
         "design": "FFT-structured: K1's passes (csrc/fft_rows.cuh) with "
                   "the DCT basis, one transform of length d2 per row pair",
         "direct_sum_bound_ms": k4["direct_flops"] / H100_PEAK["float32"]
         * 1e3},
        {"name": "dct_dc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dct_deltaw.cu",
         "replaces": "src/repro/kernels/dct_deltaw.py:114",
         "launches": k5_train, "max_abs_err": k5["err"],
         "launches_by_path": {"train": k5_train,
                              "qwen2vl_dct_train":
                                  fl["qwen2vl_dct_train"]["K5"],
                              "cluster_train": fam_cluster["K5"]["train"]},
         "cluster_shapes": k5_cluster,
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": k5["library_ms"],
         "library_call": "torch.matmul(g, C2) on prebuilt bases, "
                         "C1-weighted row sum",
         "design": "FFT-structured: K2's passes (csrc/fft_rows.cuh) with "
                   "the DCT basis, one transform of length d2 per row pair",
         "direct_sum_bound_ms": k5["direct_flops"] / H100_PEAK["float32"]
         * 1e3},
        {"name": "fused_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_attention.cu",
         "replaces": "src/repro/models/attention.py (direct einsum path; "
                     "no TPU kernel)",
         "launches": fa_train[0], "bwd_launches": fa_train[1],
         "launches_by_path": {"train": fa_train[0]},
         "shape": fused["shape"], "max_rel_err": max(
             e for n_, e in fused["errs"].items() if n_ != "lse"),
         "lse_abs_err": fused["errs"]["lse"],
         "ms": fused["ms"], "fb_ms": fused["fb_ms"],
         "plain_ms": fused["plain_ms"], "plain_fb_ms": fused["plain_fb_ms"],
         "direct_ms": fused["direct_ms"],
         "direct_fb_ms": fused["direct_fb_ms"],
         "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
         "fb_bound_ms": fused["fb_bound_ms"],
         "library_ms": fused["library_ms"],
         "library_fb_ms": fused["library_fb_ms"],
         "library_call": "torch.nn.functional.scaled_dot_product_attention "
                         "(causal, enable_gqa)",
         "design": "FlashAttention-2 on mma.sync bf16 / f32 accumulate, "
                   "cp.async double-buffered K/V; backward a dq pass and a "
                   "dk/dv pass (no atomics), dS as bf16 hi + lo"},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/models/mamba2.py ssd_chunked (XLA; no TPU "
                     "kernel)",
         "launches": sl["ssm_train"]["SSD"] + sl["hybrid_train"]["SSD"],
         "bwd_launches": sl["ssm_train"]["SSDb"]
         + sl["hybrid_train"]["SSDb"],
         "launches_by_path": {"ssm_train": sl["ssm_train"]["SSD"],
                              "hybrid_train": sl["hybrid_train"]["SSD"]},
         "bwd_launches_by_path": {
             "ssm_train": sl["ssm_train"]["SSDb"],
             "hybrid_train": sl["hybrid_train"]["SSDb"]},
         "by_geometry": {
             f"{name_} {dt_}": {k_: ssm[key_][dt_][k_] for k_ in (
                 "kernel_y", "kernel_state", "kernel_grad", "kernel_fwd_ms",
                 "kernel_fwd_bwd_ms", "fwd_ms", "fwd_bwd_ms",
                 "kernel_bound_ms", "kernel_fwd_bwd_bound_ms", "bound_ms",
                 "fwd_bwd_bound_ms", "kernel_fwd_peak_gib",
                 "kernel_fwd_bwd_peak_gib")}
             for name_, key_ in (("mamba2-2.7b", "scan"),
                                 ("zamba2-7b-instruct", "scan_pack4k"))
             for dt_ in ("bfloat16", "float32")},
         "shape": "zamba2-7b-instruct, B 1, S 4096, bf16 x/B/C",
         "ms": ssm["scan_pack4k"]["bfloat16"]["kernel_fwd_ms"],
         "fb_ms": ssm["scan_pack4k"]["bfloat16"]["kernel_fwd_bwd_ms"],
         "plain_ms": ssm["scan_pack4k"]["bfloat16"]["fwd_ms"],
         "plain_fb_ms": ssm["scan_pack4k"]["bfloat16"]["fwd_bwd_ms"],
         "bound_ms": ssm["scan_pack4k"]["bfloat16"]["kernel_bound_ms"],
         "fb_bound_ms":
             ssm["scan_pack4k"]["bfloat16"]["kernel_fwd_bwd_bound_ms"],
         "plain_bound_ms": ssm["scan_pack4k"]["bfloat16"]["bound_ms"],
         "plain_fb_bound_ms":
             ssm["scan_pack4k"]["bfloat16"]["fwd_bwd_bound_ms"],
         "library_ms": None,
         "design": "f32 FFMA on the CUDA cores, 4 x 4 register blocks; "
                   "states passed over chunks of 64 rows (the sequence "
                   "padded with zero rows to a multiple); C·Bᵀ and its "
                   "gradient shared by 8 heads a block; no atomics"},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
