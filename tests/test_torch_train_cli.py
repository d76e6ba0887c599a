"""The port's training launcher on the CPU: the counterparts of
``tests/test_system.py``'s four tests (an injected failure and restart,
resume across invocations, microbatching with remat) with ``--device
cpu``, run in this process; gemma3-12b's smoke config at the default seq
128, whose local layers train through ``swa_attention``'s Function;
``--autotune``, and a ``--data-model`` mesh without as many ranks, are
refused."""

import os

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def run_train(capsys, tmp, extra):
    rc = train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                     "--batch", "4", "--seq", "32", "--ckpt-dir", tmp,
                     "--ckpt-every", "5", "--log-every", "5"] + extra)
    assert rc == 0
    return capsys.readouterr().out


def test_train_completes_and_checkpoints(tmp_path, capsys):
    d = str(tmp_path / "ck")
    out = run_train(capsys, d, ["--steps", "12"])
    assert "done: 12 steps" in out
    assert "step     0 loss " in out and " gnorm " in out
    assert any(f.startswith("step_") for f in os.listdir(d))
    assert os.path.exists(os.path.join(d, "heartbeat.json"))


def test_train_survives_injected_failure(tmp_path, capsys):
    d = str(tmp_path / "ck")
    out = run_train(capsys, d, ["--steps", "12", "--inject-failure-at", "8"])
    assert "injected failure" in out
    assert "[restore] resumed from step 5" in out
    assert "done: 12 steps" in out
    assert "1 restarts" in out


def test_train_resumes_across_invocations(tmp_path, capsys):
    d = str(tmp_path / "ck")
    first = run_train(capsys, d, ["--steps", "10"])
    out = run_train(capsys, d, ["--steps", "15"])  # picks up at step 10
    assert "resumed from step 10" in out
    assert "done: 15 steps" in out
    # the same run in one go logs the same loss at step 10
    whole = run_train(capsys, str(tmp_path / "one"), ["--steps", "15"])
    line = next(ln for ln in whole.splitlines() if ln.startswith("step    10"))
    assert line in out and "step    10" not in first


def test_train_with_microbatching_and_remat(tmp_path, capsys):
    d = str(tmp_path / "ck")
    out = run_train(capsys, d, ["--steps", "4", "--microbatches", "2",
                                "--remat", "full"])
    assert "done: 4 steps" in out


def test_train_gemma3_smoke_takes_the_windowed_backward(tmp_path, capsys,
                                                         monkeypatch):
    """At the default seq 128 the 5 local layers of gemma3's smoke period
    take ``swa_attention`` (window 8), so each step runs its backward 5
    times."""
    calls = []
    real = ref.sliding_window_attention_bwd

    def counted(*args, **kw):
        calls.append(kw["window"])
        return real(*args, **kw)
    monkeypatch.setattr(ref, "sliding_window_attention_bwd", counted)
    rc = train.main(["--arch", "gemma3-12b", "--smoke", "--device", "cpu",
                     "--steps", "2", "--ckpt-dir", str(tmp_path / "ck")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "done: 2 steps" in out and "step     0 loss " in out
    assert calls == [8] * 10


@pytest.mark.parametrize("flags, words", [
    (["--autotune"], "--autotune measures the hand-written kernels"),
    (["--data-model", "2", "1"], "a (2, 1) mesh needs 2 ranks")])
def test_train_refuses(tmp_path, capsys, flags, words):
    with pytest.raises(SystemExit) as e:
        train.main(["--smoke", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path / "ck")] + flags)
    assert e.value.code == 2
    assert words in capsys.readouterr().err
    assert not (tmp_path / "ck").exists()
