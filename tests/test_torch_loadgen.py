"""The port's load harness (`repro_torch.launch.loadgen`) against the JAX
package's (`benchmarks/loadgen.py`), on the CPU: the same flags and seed
give byte-identical payloads, the report's percentiles and SLO attainment
are the same numbers on the same results, and against the port's gateway
(`launch.api --device cpu --port 0`, reduced yi-6b in f32, the demo
bank) it drives open-loop traffic and `--verify` finds every stream equal
to the in-process replay. The JAX script is loaded from its file here;
the port never imports it."""
import importlib.util
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import loadgen

ROOT = Path(__file__).resolve().parents[1]


def _jax_loadgen():
    name = "jax_benchmarks_loadgen"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "benchmarks" / "loadgen.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod        # its dataclass looks itself up there
        spec.loader.exec_module(mod)
    return sys.modules[name]


TRAFFIC = [
    dict(n=48, vocab=512, models=["base", "adapter:t0", "adapter:t1"],
         zipf_a=1.2, shared_frac=0.5, prefix_len=32, tail_len=4, max_new=16,
         stream=True, seed=0, priorities="interactive:0.25,batch:0.75"),
    dict(n=17, vocab=64, models=["base"], zipf_a=0.0, shared_frac=0.0,
         prefix_len=5, tail_len=1, max_new=3, stream=False, seed=7,
         priorities=None),
    dict(n=30, vocab=1000, models=["adapter:a", "base", "adapter:b"],
         zipf_a=2.5, shared_frac=1.0, prefix_len=8, tail_len=0, max_new=1,
         stream=True, seed=123, priorities="interactive,batch:2,"
                                           "best_effort:1"),
]


@pytest.mark.parametrize("kw", TRAFFIC, ids=["mixed", "plain", "skewed"])
def test_traffic_is_the_jax_scripts_byte_for_byte(kw):
    ref = _jax_loadgen()
    got = loadgen.make_traffic(**kw)
    want = ref.make_traffic(**kw)
    assert json.dumps(got).encode() == json.dumps(want).encode()
    assert loadgen.shared_prefix("adapter:t0", 32, 512, 3) \
        == ref.shared_prefix("adapter:t0", 32, 512, 3)
    assert loadgen.parse_priority_mix("interactive:1,batch:2,x") \
        == ref.parse_priority_mix("interactive:1,batch:2,x")


def _results(mod):
    """Fixed results of both modules' ReqResult: ok and failed requests,
    two classes, streamed gaps, retries (429s among them)."""
    rows = [
        ("base", "interactive", True, [1, 2, 3], 0.010, 0.030,
         [0.005, 0.015], 0),
        ("adapter:t0", "batch", True, [4, 5], 0.020, 0.050, [0.030], 2),
        ("adapter:t0", "batch", False, [], float("nan"), float("nan"), [],
         8),
        ("base", "interactive", True, [6], 0.200, 0.200, [], 1),
        ("adapter:t1", "batch", True, [7, 8, 9, 10], 0.015, 0.090,
         [0.02, 0.025, 0.03], 0),
    ]
    out = []
    for model, cls, ok, toks, ttft, lat, itl, retries in rows:
        r = mod.ReqResult(payload={"model": model, "priority": cls,
                                   "prompt": [1], "max_tokens": 4})
        r.ok, r.tokens, r.ttft_s, r.latency_s = ok, toks, ttft, lat
        r.itl_s, r.retries = itl, retries
        r.status = 200 if ok else 429
        out.append(r)
    return out


@pytest.mark.parametrize("slo", [(None, None), (50.0, None), (25.0, 20.0)],
                         ids=["no-slo", "ttft", "ttft-itl"])
def test_summary_and_slo_are_the_jax_scripts(slo):
    ref = _jax_loadgen()
    got = loadgen.summarize(_results(loadgen), 2.5, *slo)
    want = ref.summarize(_results(ref), 2.5, *slo)
    assert got.pop("throttled_429") == 0       # the fixed rows count none
    assert got == want
    assert loadgen.slo_attainment(_results(loadgen), *slo) \
        == ref.slo_attainment(_results(ref), *slo)


@pytest.fixture(scope="module")
def gateway(tmp_path_factory):
    """The API launcher in its own process on the CPU over the demo bank;
    yields (port, model flags), SIGTERMs it after."""
    tmp = tmp_path_factory.mktemp("loadgen")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    flags = ["--arch", "yi-6b", "--reduced", "--dtype", "float32",
             "--device", "cpu", "--max-len", "64", "--slots", "4"]
    demo = str(tmp / "demo")
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.api", *flags,
         "--export-demo-bank", demo], env=env, capture_output=True,
        text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    flags += ["--bank-dir", demo]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.api", *flags,
         "--port", "0", "--max-queue", "2", "--retry-after", "0.05"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "gateway listening on http://127.0.0.1:" in line, \
            line + proc.stderr.read()
        yield int(line.split("127.0.0.1:")[1].split()[0]), flags, tmp
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)


def test_loadgen_drives_the_gateway_and_verifies_the_streams(gateway,
                                                              capsys):
    """Eight requests over base and both tenants at 40 req/s against a
    queue watermark of 2 (so some are answered 429 and retried):
    every request completes and `--verify` replays them in process
    through `build_scheduler` on the same flags, stream for stream."""
    port, flags, tmp = gateway
    out = tmp / "results.json"
    loadgen.main(["--port", str(port), "--n", "8", "--rate", "40",
                  "--models", "base,adapter:t0,adapter:t1",
                  "--shared-frac", "0.5", "--prefix-len", "12",
                  "--max-new", "6", "--priorities",
                  "interactive:0.25,batch:0.75", "--slo-ttft-ms", "60000",
                  "--retries", "200", "--wait-s", "30", "--verify",
                  "--out", str(out), *flags])
    text = capsys.readouterr().out
    assert "verify: 8 streams replayed, 0 mismatches" in text
    report = json.loads(out.read_text())
    summary = report["summary"]
    assert summary["n"] == summary["ok"] == 8 and summary["failed"] == 0
    assert summary["throttled_429"] <= summary["retries"]
    assert summary["ttft_p50_ms"] > 0 and summary["tok_s"] > 0
    assert set(summary["slo"]["by_class"]) <= {"interactive", "batch"}
    assert all(len(r["tokens"]) == 6 for r in report["results"])


def test_verify_fails_on_a_stream_that_differs(gateway, capsys):
    """The check can fail: a replay whose model differs (another seed)
    gives other streams, and the loadgen exits 1."""
    port, flags, _ = gateway
    seeded = flags + ["--seed", "5"]
    with pytest.raises(SystemExit) as e:
        loadgen.main(["--port", str(port), "--n", "3", "--rate", "0",
                      "--models", "base", "--prefix-len", "6",
                      "--max-new", "4", "--verify", *seeded])
    assert e.value.code == 1
    assert "mismatches" in capsys.readouterr().out
