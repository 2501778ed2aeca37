"""The port's train driver (``repro_torch.launch.train``) and its data
pipeline copy: the batches bit for bit against ``repro.data.pipeline``
across steps and hosts; the driver on the CPU for reduced rwkv6-3b and
qwen2-7b, printing the reference driver's lines with finite losses that
repeat from one seed; whisper-small and llama-3.2-vision refused, as the
reference's token batches cannot feed them; and the driver loading
neither JAX nor ``repro``. (The JAX driver initialises its own
parameters, so parity with it is held through ``make_train_step`` on
bridged parameters, in tests/test_torch_train.py.)"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import make_pipeline as jax_make_pipeline
from repro_torch.data import SyntheticTokens, make_pipeline
from repro_torch.launch import train as port_train

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_pipeline_matches_reference_bit_for_bit(n_hosts):
    for host in range(n_hosts):
        ref = jax_make_pipeline(300, 32, 8, seed=5, n_hosts=n_hosts,
                                host_id=host)
        port = make_pipeline(300, 32, 8, seed=5, n_hosts=n_hosts,
                             host_id=host)
        assert isinstance(port, SyntheticTokens)
        assert port.host_batch == ref.host_batch == 8 // n_hosts
        for step in (0, 1, 7):
            a, b = ref.batch_at(step), port.batch_at(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        for a, b, _ in zip(iter(ref), iter(port), range(3)):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_pipeline_refuses_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="split"):
        make_pipeline(300, 32, 6, n_hosts=4).batch_at(0)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen2-7b"])
def test_driver_prints_reference_lines(arch, capsys):
    assert port_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--steps", "10", "--seq-len", "16",
                            "--global-batch", "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    steps = [re.fullmatch(r"\[train\] step (\d+) loss (\S+) \(\d+\.\ds\)", ln)
             for ln in lines[:-1]]
    assert [int(m.group(1)) for m in steps] == [0, 5, 9]
    assert all(math.isfinite(float(m.group(2))) for m in steps)
    assert re.fullmatch(r"\[train\] loss \S+ -> \S+ \((NOT )?improved\)",
                        lines[-1])


@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen2-7b"])
def test_driver_losses_finite_and_repeat_from_a_seed(arch):
    runs = [port_train.train(arch, use_reduced=True, steps=3, seq_len=16,
                             global_batch=4, device="cpu", seed=2)
            for _ in range(2)]
    assert all(math.isfinite(x) for x in runs[0].losses)
    assert runs[0].losses == runs[1].losses
    assert len(runs[0].step_s) == 3
    assert int(runs[0].state.opt.step) == 3


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-90b"])
def test_driver_refuses_cross_attention_families(arch):
    with pytest.raises(ValueError, match="token pipeline"):
        port_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "1"])


def test_train_driver_loads_no_jax_or_repro():
    code = ("import sys\n"
            "from repro_torch.launch import train\n"
            "assert train.main(['--arch', 'rwkv6-3b', '--reduced', "
            "'--device', 'cpu', '--steps', '1', '--seq-len', '8', "
            "'--global-batch', '2']) == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('isolated')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout
