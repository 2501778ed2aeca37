"""The port stands alone: no file of it imports ``jax`` or ``repro``; its
serve driver and row-paged KV cache run on the CPU without loading either;
its entry points default to ``cuda`` and raise without a card; kernel
wrappers given CPU tensors launch nothing. Also the batcher copy's
behaviour, mirroring tests/test_serve.py's batcher tests."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device
from repro_torch.kernels import launch_counters, reset_launch_counters
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.rowstream_matmul.ops import rowstream_matmul
from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
from repro_torch.launch import serve as port_serve
from repro_torch.serve.batching import ContinuousBatcher, Request
from repro_torch.serve.kv_cache import RowPagedKVCache

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_repro(path):
    assert path.exists()
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_every_port_module_is_scanned():
    """The scan above globs the package: the modules of each slice are in
    it, the MoE family's, the prefill path's, the hybrid family's, the
    row-paged cache's, the vlm and audio families' and the training
    path's included."""
    names = {str(p.relative_to(REPO / "src" / "repro_torch"))
             for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"models/moe.py", "models/transformer.py", "models/layers.py",
            "models/rwkv6.py", "configs/granite_moe_3b.py",
            "configs/phi35_moe_42b.py", "launch/serve.py",
            "models/zamba2.py", "configs/zamba2_1_2b.py",
            "serve/kv_cache.py", "serve/batching.py",
            "workloads/stream.py", "models/whisper.py", "models/mllama.py",
            "configs/whisper_small.py", "configs/llama32_vision_90b.py",
            "models/registry.py", "data/pipeline.py", "data/__init__.py",
            "train/optimizer.py", "train/grad_compress.py",
            "train/train_step.py", "train/__init__.py",
            "launch/train.py"} <= names
    assert REPO / "chip_smoke.py" in PORT_FILES


def test_serve_driver_on_cpu_loads_no_jax_or_repro():
    code = (
        "import sys\n"
        "import torch\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.configs import ALL_ARCHS, reduced\n"
        "from repro_torch.models.registry import get_adapter\n"
        "from repro_torch.serve import RowPagedKVCache, tokens_per_row\n"
        "for arch in ('qwen2-7b', 'granite-moe-3b-a800m', 'zamba2-1.2b',"
        " 'whisper-small'):\n"
        "    assert serve.main(['--arch', arch, '--reduced', '--device',"
        " 'cpu', '--requests', '2', '--slots', '2', '--max-new', '2']) == 0\n"
        "    ad = get_adapter(reduced(ALL_ARCHS[arch]))\n"
        "    p = ad.init(torch.Generator().manual_seed(0))\n"
        "    batch = {n: torch.zeros((1, 16, 64), dtype=torch.bfloat16)"
        " for n in ad.extra_inputs}\n"
        "    batch['tokens'] = torch.ones((1, 4), dtype=torch.int64)\n"
        "    ad.forward(p, batch)\n"
        "c = RowPagedKVCache(8, tokens_per_row(64, 2), 2, 64, 2, 4,"
        " device='cpu')\n"
        "c.alloc_seq(0, 0)\n"
        "runs = c.append_chunk_stream(0, 40)\n"
        "c.write(int(c.page_table[0, 0]), 0, torch.ones((2, 64)),"
        " torch.ones((2, 64)))\n"
        "assert c.gather_seq(0)[0].shape == (40, 2, 64)"
        " and len(c.read_stream(0)) == 6 == len(runs)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        port_serve.main(["--reduced", "--requests", "1", "--max-new", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        RowPagedKVCache(16, 16, 2, 64, 4, 8)
    assert resolve_device("cpu").type == "cpu"
    assert RowPagedKVCache(16, 16, 2, 64, 4, 8,
                           device="cpu").pool_k.device.type == "cpu"


def test_cpu_tensors_leave_launch_counters_at_zero():
    reset_launch_counters()
    rowstream_matmul(torch.ones((2, 8)), torch.ones((8, 3)))
    flash_decode(torch.ones((1, 4, 16)), torch.ones((1, 2, 8, 16)),
                 torch.ones((1, 2, 8, 16)), 3)
    x = torch.ones((1, 4, 2, 16))
    rwkv_scan(x, x, x, x * 0.5, torch.zeros((2, 16)))
    r = x.clone().requires_grad_(True)
    rwkv_scan(r, x, x, x * 0.5, torch.zeros((2, 16)))[0].sum().backward()
    assert r.grad is not None
    counters = launch_counters()
    assert set(counters) == {"flash_decode", "rowstream_matmul", "rwkv_scan",
                             "rwkv_scan_bwd"}
    assert all(c.count == 0 for c in counters.values())


# --- the batcher copy (tests/test_serve.py's batcher tests) ------------------

def test_batcher_fifo_and_retire():
    b = ContinuousBatcher(2)
    for rid in range(4):
        b.submit(Request(rid, np.array([1, 2]), max_new_tokens=2))
    adm = b.schedule()
    assert [r.rid for _, r in adm] == [0, 1]
    b.record_tokens(np.array([10, 11]))
    done = b.record_tokens(np.array([12, 13]))
    assert sorted(r.rid for r in done) == [0, 1]
    adm2 = b.schedule()
    assert [r.rid for _, r in adm2] == [2, 3]


def test_batcher_iteration_level_join():
    b = ContinuousBatcher(2)
    b.submit(Request(0, np.array([1]), max_new_tokens=1))
    b.submit(Request(1, np.array([1]), max_new_tokens=3))
    b.submit(Request(2, np.array([1]), max_new_tokens=1))
    b.schedule()
    b.record_tokens(np.array([5, 6]))        # r0 done
    adm = b.schedule()
    assert [r.rid for _, r in adm] == [2]
    assert b.active[0].rid == 2 and b.active[1].rid == 1


def test_occupancy_zero_before_first_step():
    b = ContinuousBatcher(4)
    assert b.occupancy == 0.0
    b.submit(Request(0, np.array([1]), 1))
    assert b.occupancy == 0.0


def test_request_timeline_step_indices():
    b = ContinuousBatcher(1)
    r0 = Request(0, np.array([1]), max_new_tokens=2)
    r1 = Request(1, np.array([1]), max_new_tokens=1)
    b.submit(r0)
    b.submit(r1)
    assert r0.timeline.submitted_step == 0 and r1.timeline.submitted_step == 0
    b.schedule()
    assert r0.timeline.admitted_step == 0
    assert r1.timeline.admitted_step == -1
    b.record_tokens(np.array([7]))
    assert r0.timeline.first_token_step == 0
    assert r0.timeline.completed_step == -1
    b.schedule()
    b.record_tokens(np.array([8]))
    assert r0.timeline.completed_step == 1
    assert r0.timeline.decode_steps == 2 == len(r0.out_tokens)
    b.schedule()
    assert r1.timeline.admitted_step == 2
    b.record_tokens(np.array([9]))
    assert r1.timeline.first_token_step == 2
    assert r1.timeline.completed_step == 2
    assert r1.timeline.decode_steps == 1


def test_admission_check_blocks():
    b = ContinuousBatcher(2, admit=lambda req: req.rid != 1)
    b.submit(Request(0, np.array([1]), 1))
    b.submit(Request(1, np.array([1]), 1))
    adm = b.schedule()
    assert [r.rid for _, r in adm] == [0]
    assert b.queue[0].rid == 1
