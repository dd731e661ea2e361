"""The port's training runtime on the CPU, mirroring
tests/test_train_fault_tolerance.py (without its mesh test: the port trains
on one device): the step-atomic checkpointer, resume, failure injection
and restart, the straggler watchdog, gradient compression and
determinism; the synthetic token stream, whose batches must equal the
reference's bit for bit; and the ``launch.train`` CLI.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import lm as RL
from repro_torch import configs
from repro_torch.data.lm import DataConfig, TokenStream, \
    bigram_entropy_estimate
from repro_torch.optim import AdamWConfig
from repro_torch.train import (Checkpointer, FailureInjector, LoopConfig,
                               init_train_state, make_train_step, train)

ROOT = Path(__file__).resolve().parents[1]
CFG = configs.reduced_config("gemma-2b")
OPT = AdamWConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=100)
CPU = dict(device="cpu", verbose=False)


def _stream(batch=4, seq=16):
    return TokenStream(DataConfig(vocab=CFG.vocab, batch=batch, seq_len=seq),
                       device="cpu")


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("order,shard,step", [(1, (0, 1), 0), (1, (1, 2), 7),
                                              (2, (0, 1), -1),
                                              (2, (2, 4), 3)])
def test_token_stream_equals_the_reference_bit_for_bit(order, shard, step):
    cfg = dict(vocab=300, batch=8, seq_len=24, seed=5, order=order)
    want = RL.TokenStream(RL.DataConfig(**cfg), shard=shard).batch(step)
    got = TokenStream(DataConfig(**cfg), shard=shard,
                      device="cpu").batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int64 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]).astype(np.int64))
    assert got["mask"].dtype == torch.float32
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))


def test_data_stateless_sharded_shifted_and_learnable():
    cfg = DataConfig(vocab=256, batch=8, seq_len=16)
    b0 = TokenStream(cfg, device="cpu").batch(3)
    assert torch.equal(b0["tokens"], TokenStream(cfg, device="cpu")
                       .batch(3)["tokens"])
    sh0 = TokenStream(cfg, shard=(0, 2), device="cpu").batch(3)
    sh1 = TokenStream(cfg, shard=(1, 2), device="cpu").batch(3)
    assert sh0["tokens"].shape == (4, 16)
    assert not torch.equal(sh0["tokens"], sh1["tokens"])
    assert torch.equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    h = bigram_entropy_estimate(cfg, n_samples=2000)
    assert h == RL.bigram_entropy_estimate(RL.DataConfig(vocab=256, batch=8,
                                                         seq_len=16),
                                           n_samples=2000)
    assert h < 0.75 * np.log(256)
    assert len(list(TokenStream(cfg, device="cpu").eval_batches())) == 4


def test_the_stream_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        TokenStream(DataConfig(vocab=10, batch=1, seq_len=4))


# --------------------------------------------------------------------------
# checkpointer
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip_in_place(tmp_path):
    ck = Checkpointer(tmp_path)
    bf = torch.full((3, 4), 1.5, dtype=torch.bfloat16)
    tree = {"a": torch.arange(10.0), "b": {"c": bf},
            "n": torch.tensor(7, dtype=torch.int32)}
    ck.save(7, tree, extra={"next_step": 7})
    manifest = (tmp_path / "step_00000007" / "MANIFEST.json").read_text()
    assert '"bfloat16"' in manifest
    like = {"a": torch.zeros(10),
            "b": {"c": torch.zeros((3, 4), dtype=torch.bfloat16)},
            "n": torch.zeros((), dtype=torch.int32)}
    target = like["b"]["c"]
    out, extra = ck.restore(like)
    assert extra["next_step"] == 7 and out is like
    assert out["b"]["c"] is target and target.dtype == torch.bfloat16
    assert torch.equal(out["a"], torch.arange(10.0))
    assert torch.equal(target, tree["b"]["c"])
    assert int(out["n"]) == 7 and out["n"].shape == ()


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"x": torch.zeros(4)})
    bad = tmp_path / "step_00000002.tmp"
    bad.mkdir()
    (bad / "leaf_00000.npy").write_bytes(b"garbage")
    assert ck.latest_step() == 1
    like = {"x": torch.ones(4)}
    ck.restore(like)
    assert torch.equal(like["x"], torch.zeros(4))


def test_checkpoint_gc_retention(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.zeros(2)})
    steps = sorted(int(d.name[5:]) for d in tmp_path.iterdir()
                   if d.name.startswith("step_"))
    assert steps == [3, 4]


def test_checkpoint_async_overlap_snapshots_at_save(tmp_path):
    ck = Checkpointer(tmp_path)
    x = torch.arange(1000.0)
    ck.save_async(5, {"x": x})
    x.add_(1.0)                   # the next step updates in place
    ck.wait()
    assert ck.latest_step() == 5
    like = {"x": torch.zeros(1000)}
    ck.restore(like)
    assert torch.equal(like["x"], torch.arange(1000.0))


def test_checkpoint_shape_mismatch_raises_and_writes_nothing(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"a": torch.ones(3), "x": torch.zeros(4)})
    like = {"a": torch.zeros(3), "x": torch.zeros(5)}
    with pytest.raises(ValueError):
        ck.restore(like)
    assert torch.equal(like["a"], torch.zeros(3))
    with pytest.raises(KeyError):
        ck.restore({"y": torch.zeros(4)})


def test_checkpoint_of_a_train_state(tmp_path):
    state = init_train_state(CFG, torch.Generator().manual_seed(0),
                             compress=True, device="cpu")
    ck = Checkpointer(tmp_path)
    ck.save(3, state)
    other = init_train_state(CFG, torch.Generator().manual_seed(1),
                             compress=True, device="cpu")
    ck.restore(other)
    for (n, p), (_, q) in zip(state.params.named_parameters(),
                              other.params.named_parameters()):
        assert torch.equal(p, q) and q.requires_grad, n
    assert set(other.opt["mu"]) == set(dict(state.params.named_parameters()))


# --------------------------------------------------------------------------
# loop
# --------------------------------------------------------------------------

def test_resume_is_exact(tmp_path):
    """12 straight steps == 6 steps + restart + 6 steps, bit for bit."""
    ds = _stream()
    straight = train(CFG, ds.batch, LoopConfig(total_steps=12,
                                               ckpt_every=100, log_every=1),
                     OPT, seed=0, **CPU)
    d1 = tmp_path / "resume"
    train(CFG, ds.batch, LoopConfig(total_steps=6, ckpt_every=6,
                                    log_every=1), OPT, ckpt_dir=str(d1),
          seed=0, **CPU)
    second = train(CFG, ds.batch, LoopConfig(total_steps=12, ckpt_every=6,
                                             log_every=1), OPT,
                   ckpt_dir=str(d1), seed=0, **CPU)
    assert [m["loss"] for m in second.metrics_history] == \
        [m["loss"] for m in straight.metrics_history][6:]
    for p, q in zip(second.state.params.parameters(),
                    straight.state.params.parameters()):
        assert torch.equal(p, q)


def test_failure_injection_restores_the_newest_checkpoint(tmp_path):
    ds = _stream()
    res = train(CFG, ds.batch,
                LoopConfig(total_steps=10, ckpt_every=3, log_every=1), OPT,
                ckpt_dir=str(tmp_path), seed=0,
                failure_injector=FailureInjector(fail_at=(5, 8)), **CPU)
    assert res.restarts == 2 and res.final_step == 10
    steps = [int(m["step"]) for m in res.metrics_history]
    # 0..4, then from the step-3 checkpoint 3..7, then from step 6: 6..9
    assert steps == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7, 6, 7, 8, 9]
    straight = train(CFG, ds.batch, LoopConfig(total_steps=10, log_every=1),
                     OPT, seed=0, **CPU)
    assert res.losses[-4:] == straight.losses[-4:]


def test_failure_without_ckpt_raises():
    with pytest.raises(RuntimeError):
        train(CFG, _stream().batch, LoopConfig(total_steps=5), OPT,
              failure_injector=FailureInjector(fail_at=(2,)), **CPU)


def test_meshes_are_not_ported():
    for kw in (dict(mesh=object()),
               dict(make_mesh_after_failure=lambda i: None)):
        with pytest.raises(NotImplementedError):
            train(CFG, _stream().batch, LoopConfig(total_steps=1), OPT,
                  **kw, **CPU)


def test_straggler_watchdog_detects_slow_steps(monkeypatch):
    """Step 7 takes 1 s where the others take 10 ms, on a clock the test
    advances (a CPU shared by test workers makes wall-clock steps vary
    too much for a fixed factor)."""
    from repro_torch.train import loop as loop_mod

    class Clock:
        now = 0.0

        def time(self):
            return self.now

    clock = Clock()
    monkeypatch.setattr(loop_mod, "time", clock)
    ds = _stream(batch=2, seq=8)
    slow_seen = []

    def delayed_batch(step):
        clock.now += 1.0 if step == 7 else 0.01    # inject a straggler
        return ds.batch(step)

    res = train(CFG, delayed_batch,
                LoopConfig(total_steps=10, log_every=100,
                           straggler_factor=4.0, straggler_warmup=2),
                OPT, on_straggler=lambda s, dt: slow_seen.append(s), **CPU)
    assert [e["step"] for e in res.straggler_events] == [7]
    assert slow_seen == [7]


def test_gradient_compression_trains():
    res = train(CFG, _stream().batch, LoopConfig(total_steps=6, log_every=1),
                OPT, compress=True, **CPU)
    assert all(np.isfinite(x) for x in res.losses)
    assert res.state.ef is not None


def test_determinism_same_seed_same_losses():
    ds = _stream()
    r1 = train(CFG, ds.batch, LoopConfig(total_steps=4, log_every=1), OPT,
               seed=3, **CPU)
    r2 = train(CFG, ds.batch, LoopConfig(total_steps=4, log_every=1), OPT,
               seed=3, **CPU)
    assert r1.losses == r2.losses


def test_training_lowers_the_loss_on_the_cpu():
    cfg = dataclasses.replace(configs.reduced_config("rwkv6-1.6b"),
                              dtype=torch.float32)
    ds = TokenStream(DataConfig(vocab=cfg.vocab, batch=4, seq_len=32),
                     device="cpu")
    res = train(cfg, ds.batch, LoopConfig(total_steps=30, log_every=1),
                AdamWConfig(peak_lr=3e-3, warmup_steps=3, decay_steps=30),
                **CPU)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5]) - 0.05
    step = make_train_step(cfg, OPT)
    _, m = step(res.state, ds.batch(0))
    assert set(m) == {"ce", "z_loss", "loss", "aux", "grad_norm", "lr"}


# --------------------------------------------------------------------------
# launcher
# --------------------------------------------------------------------------

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_train_cli_on_the_cpu(tmp_path):
    res = _cli("--arch", "gemma-2b", "--reduced", "--device", "cpu",
               "--steps", "4", "--batch", "2", "--seq", "16",
               "--log-every", "1", "--ckpt-dir", str(tmp_path),
               "--ckpt-every", "2")
    assert res.returncode == 0, res.stderr
    assert "[train] done: 4 steps" in res.stdout
    assert sorted(d.name for d in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000004"]


def test_train_cli_refuses_embeds_and_meshes():
    from repro_torch.launch import train as LT
    with pytest.raises(SystemExit, match="embeddings"):
        LT.run(["--arch", "musicgen-large", "--reduced", "--device", "cpu"])
    with pytest.raises(SystemExit):
        LT.parse_args(["--mesh", "smoke"])
