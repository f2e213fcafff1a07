"""The port's checkpoints, fault-tolerant loop and training launcher
(``repro_torch.checkpoint.ckpt``, ``repro_torch.runtime.fault``,
``repro_torch.launch.train``) on the CPU: the twins of
``tests/test_fault.py``'s checkpoint and restart tests, the bad-step
guard, the CLI with ``--smoke --device cpu``, and the examples' twins
(``examples/train_lm_torch.py``, ``examples/async_training_torch.py``,
the latter held to the reference example's output line).  A restarted
run is held to a clean run of the port, exactly.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def test_ckpt_roundtrip_with_bf16(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((3, 4), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32)},
            "bf": torch.randn((7, 3), generator=g).bfloat16(),
            "s": np.asarray(7, np.int64),
            "opt": adamw.AdamWState(
                torch.tensor(3, dtype=torch.int32),
                {"w": torch.randn(4, generator=g)},
                {"w": torch.rand(4, generator=g)},
                {"w": torch.randn(4, generator=g)})}
    ckpt.save(tmp_path, 3, tree)
    assert ckpt.latest_step(tmp_path) == 3
    like = {"a": torch.zeros(3, 4),
            "b": {"c": torch.zeros(5, dtype=torch.int32)},
            "bf": torch.zeros(7, 3, dtype=torch.bfloat16),
            "s": np.zeros((), np.int64),
            "opt": adamw.AdamWState(torch.zeros((), dtype=torch.int32),
                                    {"w": torch.zeros(4)},
                                    {"w": torch.zeros(4)},
                                    {"w": torch.zeros(4)})}
    out = ckpt.restore(tmp_path, 3, like)
    assert isinstance(out["opt"], adamw.AdamWState)
    assert out["bf"].dtype == torch.bfloat16
    assert torch.equal(out["bf"].view(torch.int16),
                       tree["bf"].view(torch.int16))      # the same bits
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert int(out["s"]) == 7 and isinstance(out["s"], np.ndarray)
    for x, y in zip(out["opt"], tree["opt"]):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
        else:
            assert all(torch.equal(x[k], y[k]) for k in x)
    with pytest.raises(ValueError):          # another dtype than saved
        ckpt.restore(tmp_path, 3, dict(like, a=torch.zeros(3, 4).double()))


def test_ckpt_async_snapshot_and_atomicity(tmp_path):
    saver = ckpt.AsyncSaver()
    w = torch.ones((4, 4))
    saver.save_async(tmp_path, 1, {"w": w})
    w.add_(1)                   # an in-place update after the snapshot
    saver.wait()
    assert ckpt.latest_step(tmp_path) == 1
    assert torch.equal(ckpt.restore(tmp_path, 1, {"w": w})["w"],
                       torch.ones((4, 4)))
    # a crash mid-write: the temporary directory, and a final-named one
    # without its manifest, are ignored
    tmp = tmp_path / ".tmp_step_00000002"
    tmp.mkdir()
    (tmp / "w.s0.npy").write_bytes(b"garbage")
    bad = tmp_path / "step_00000003"
    bad.mkdir()
    (bad / "w.s0.npy").write_bytes(b"garbage")
    assert ckpt.latest_step(tmp_path) == 1


def _loop(tmp_path, name, fail_at=None, n_steps=12):
    cfg = configs.get_smoke("qwen3_0p6b")
    return train.build(cfg, batch=4, seq=32, lr=1e-3, steps=n_steps,
                       device="cpu", ckpt_dir=str(tmp_path / name),
                       ckpt_every=4, inject_failure_at=fail_at)


def test_restart_reproduces_clean_run(tmp_path):
    """A failure injected at step 6 restarts from step 4's checkpoint; the
    run ends where a clean run ends, to the bit."""
    loop1, mb1 = _loop(tmp_path, "clean")
    clean = loop1.run(mb1, 12)
    loop2, mb2 = _loop(tmp_path, "faulty", fail_at=6)
    faulty = loop2.run(mb2, 12)
    assert clean["restarts"] == 0 and faulty["restarts"] == 1
    assert faulty["steps"] == clean["steps"] == 12
    assert faulty["final_loss"] == clean["final_loss"]
    # the faulty run's history: steps 0-5, then 4-11 again after the restore
    assert [s for s, _ in loop2.history] == [*range(6), *range(4, 12)]
    assert dict(loop2.history) == dict(loop1.history)


def test_loop_skips_a_non_finite_step(tmp_path):
    """The bad-step guard: a step whose loss is not finite is counted and
    applies nothing; the run goes on and the optimizer counts one step
    fewer."""
    loop, mb = _loop(tmp_path, "nan", n_steps=6)
    step = loop.train_step
    seen = {"n": 0, "state": None}

    def poisoned(model, opt, batch):
        seen["n"] += 1
        if seen["n"] != 3:
            out = step(model, opt, batch)
            seen["state"] = out[1]
            return out
        with torch.no_grad():
            saved = model.ln_f.clone()
            model.ln_f.fill_(float("nan"))
        before = [t.clone() for t in (opt.step, *opt.m.values())]
        out = step(model, opt, batch)
        with torch.no_grad():
            model.ln_f.copy_(saved)
        assert out[2]["skipped"] and out[1] is opt
        after = [opt.step, *opt.m.values()]
        assert all(torch.equal(a, b) for a, b in zip(after, before))
        return out

    loop.train_step = poisoned
    summary = loop.run(mb, 6)
    assert summary["bad_steps"] == 1 and summary["steps"] == 6
    assert [s for s, _ in loop.history] == [0, 1, 3, 4, 5]
    assert int(seen["state"].step) == 5


def test_cli_on_the_cpu(tmp_path, capsys):
    summary = train.main(["--arch", "qwen3_0p6b", "--smoke", "--device",
                          "cpu", "--steps", "6", "--batch", "4", "--seq",
                          "32", "--ckpt-dir", str(tmp_path), "--ckpt-every",
                          "3", "--inject-failure-at", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen3-0.6b-smoke steps=6 restarts=1 "
                             "final_loss=")
    assert out[1].startswith("loss ") and "->" in out[1]
    assert summary["restarts"] == 1 and ckpt.latest_step(tmp_path) == 6


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_1p2b", "dbrx_132b",
                                  "llama3p2_vision_11b", "hubert_xlarge"])
def test_cli_trains_every_family_on_the_cpu(tmp_path, capsys, arch):
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
                str(tmp_path), "--ckpt-every", "0"])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith(f"arch={configs.get_smoke(arch).name} steps=2 ")
    assert ckpt.latest_step(tmp_path) is None


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would train")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])


ROOT = Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


@pytest.mark.parametrize("policy", ["ppcc", "occ"])
def test_async_training_twin_prints_the_reference_line(policy):
    """``examples/async_training_torch.py --device cpu`` prints the line of
    ``examples/async_training.py``: the same ticks, admissions, aborted
    work and final loss."""
    args = ["--policy", policy, "--updates", "60"]
    want = _run("examples/async_training.py", *args)
    got = _run("examples/async_training_torch.py", *args, "--device", "cpu")
    assert got == want and got.startswith(f"policy={policy} updates=")


def test_train_lm_twin_on_the_cpu(tmp_path):
    out = _run("examples/train_lm_torch.py", "--device", "cpu", "--steps",
               "3", "--ckpt-dir", str(tmp_path)).splitlines()
    assert out[0].startswith("arch=llama3.2-1b-smoke steps=3 restarts=0 ")
