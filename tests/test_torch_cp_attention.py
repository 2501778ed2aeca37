"""The context-parallel decode attention of the port against the
reference's: ``layers.cached_attention_update`` on 1x2 and 2x2 meshes of
spawned gloo ranks (``_torch_dist_worker.py``; one 2-rank and one 4-rank
spawn) at tests/test_distributed_mesh.py's shapes, each rank holding its
batch rows and its slots of the cache, against JAX's
``cached_attention_update``; the plain partial of ``flash_decode`` over 1,
2 and 4 shards of a cache, merged, against JAX's Pallas ``flash_decode``
(interpret mode) and ``_cached_attention_local(axis=None)``; an empty
shard, one shard, and a model axis that does not divide the cache."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as worker
from repro.kernels.flash_decode.kernel import flash_decode as jax_flash_decode
from repro.models import layers as jax_layers
from repro_torch.kernels.flash_decode.ops import flash_decode_partial
from repro_torch.kernels.flash_decode.ref import (NEG_INF, flash_decode_ref,
                                                  flash_decode_partial_ref,
                                                  merge_partials)
from repro_torch.models import layers

# tests/test_distributed_mesh.py::test_cp_attention_matches_local's shapes.
B, HQ, HKV, S, HD = 2, 8, 2, 32, 16
# (pos, slot): shard 1 of 2 empty (0, 15), its first slot (16), inside it
# (20), the last slot (31), and a sliding window's ring buffer past S.
CASES = [(0, 0), (15, 15), (16, 16), (20, 20), (31, 31), (40, 40 % S)]
MESHES = ["1x2", "2x2"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _case(pos: int, slot: int) -> tuple:
    rng = np.random.default_rng(100 + pos)
    f = (lambda *shape: rng.standard_normal(shape).astype(np.float32))
    return (f(B, HQ, 1, HD), f(B, HKV, 1, HD), f(B, HKV, 1, HD),
            f(B, HKV, S, HD), f(B, HKV, S, HD), pos, slot)


def _jax_update(case) -> tuple:
    q, kn, vn, kc, vc, pos, slot = case
    out, kc, vc = jax_layers.cached_attention_update(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc)),
        jnp.array(pos, jnp.int32), jnp.array(slot, jnp.int32))
    return np.asarray(out), np.asarray(kc), np.asarray(vc)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cp")
    cases = [_case(*c) for c in CASES]
    torch.save([tuple(torch.from_numpy(a) if isinstance(a, np.ndarray)
                      else a for a in c) for c in cases], tmp / "cases.pt")
    got = {}
    for world, meshes in ((2, ["1x2"]), (4, ["2x2"])):
        got.update(worker.spawn(world, str(tmp), [
            ("cp_attention", (str(tmp / "cases.pt"), meshes))])
            ["cp_attention"])
    return {"cases": cases, "got": got}


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"pos{p}_slot{s}" for p, s in CASES])
@pytest.mark.parametrize("mesh", MESHES)
def test_cp_attention_matches_jax(runs, mesh, case):
    """Output within 1e-5 in fp32, caches gathered bit for bit."""
    want_o, want_k, want_v = _jax_update(runs["cases"][case])
    out, kc, vc, local = runs["got"][mesh][case]
    data = int(mesh.split("x")[0])
    assert local == (B // data, HKV, S // 2, HD)
    np.testing.assert_allclose(out.numpy(), want_o, rtol=1e-5, atol=1e-5)
    assert np.array_equal(kc.numpy(), want_k)
    assert np.array_equal(vc.numpy(), want_v)


class ModelAxis:
    """What the collectives read of a DeviceMesh: one ``model`` axis."""

    def __init__(self, n):
        self.mesh_dim_names = ("model",)
        self._n = n

    def size(self, dim):
        return self._n


def test_cp_attention_local_where_model_does_not_divide_s():
    """A model axis of 3 does not divide S 32: the whole caches take the
    local path, as the reference's decision does (no collective runs)."""
    case = _case(20, 20)
    want_o, want_k, _ = _jax_update(case)
    q, kn, vn, kc, vc, pos, slot = (torch.from_numpy(a.copy())
                                    if isinstance(a, np.ndarray) else a
                                    for a in case)
    out = layers.cached_attention_update(q, kn, vn, kc, vc, pos, slot,
                                         ModelAxis(3))
    np.testing.assert_allclose(out.numpy(), want_o, rtol=1e-5, atol=1e-5)
    assert np.array_equal(kc.numpy(), want_k)


def test_cp_attention_without_mesh_is_the_local_path():
    case = _case(31, 31)
    want_o, want_k, want_v = _jax_update(case)
    q, kn, vn, kc, vc, pos, slot = (torch.from_numpy(a.copy())
                                    if isinstance(a, np.ndarray) else a
                                    for a in case)
    out = layers.cached_attention_update(q, kn, vn, kc, vc, pos, slot)
    np.testing.assert_allclose(out.numpy(), want_o, rtol=1e-5, atol=1e-5)
    assert np.array_equal(kc.numpy(), want_k)
    assert np.array_equal(vc.numpy(), want_v)


# --- the plain partial and the merge -----------------------------------------

def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _sharded(q, kc, vc, pos, n):
    """The merged partials of `n` contiguous shards of the caches, shard r
    valid up to pos as the context-parallel branch counts it."""
    S_loc = kc.shape[2] // n
    parts = [flash_decode_partial_ref(
        q, kc[:, :, r * S_loc:(r + 1) * S_loc].contiguous(),
        vc[:, :, r * S_loc:(r + 1) * S_loc].contiguous(),
        min(max(pos + 1 - r * S_loc, 0), S_loc)) for r in range(n)]
    return merge_partials(*zip(*parts))


@pytest.mark.parametrize("b,h,hkv,s,d,pos", [(2, 8, 2, 128, 64, 64),
                                             (1, 4, 4, 256, 64, 200),
                                             (3, 16, 4, 64, 128, 10),
                                             (2, 8, 2, 128, 64, 300)])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partials_merged_match_jax_flash_decode(b, h, hkv, s, d, pos, shards,
                                                dtype):
    """Merged over 1, 2 and 4 shards (some empty, and a ring buffer with
    pos >= S) against the Pallas kernel and the reference's local
    attention, at the flash_decode tolerances of tests/test_kernels.py."""
    rng = np.random.default_rng(b * h + s + d + pos)
    qj, qt = _pair(rng.standard_normal((b, h, d), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((b, hkv, s, d), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((b, hkv, s, d), np.float32), dtype)
    out = _sharded(qt, kt, vt, pos, shards)
    assert out.dtype == qt.dtype and out.shape == (b, h, d)
    tol = TOL[dtype]
    pj = jnp.array(pos, jnp.int32)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(
        jax_flash_decode(qj, kj, vj, pj), np.float32), rtol=tol, atol=tol)
    local, _, _ = jax_layers._cached_attention_local(
        qj[:, :, None], kj[:, :, :1], vj[:, :, :1], kj, vj, pj,
        jnp.array(s, jnp.int32), None)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(
        local[:, :, 0], np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_shard_weighs_nothing(dtype):
    """n_valid 0: out 0, m -1e30, l 0 from the plain version and the
    wrapper; merged beside a shard it leaves that shard's attention."""
    rng = np.random.default_rng(3)
    tdt = DTYPES[dtype][1]
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(tdt) for shape in ((2, 8, 64), (2, 2, 32, 64),
                                           (2, 2, 32, 64)))
    for fn in (flash_decode_partial_ref, flash_decode_partial):
        out, m, l = fn(q, kc, vc, 0)
        assert out.dtype == q.dtype and not out.any()
        assert m.dtype == l.dtype == torch.float32
        assert bool((m == NEG_INF).all()) and not l.any()
    full = flash_decode_partial_ref(q, kc, vc, 20)
    merged = merge_partials([full[0], out], [full[1], m], [full[2], l])
    torch.testing.assert_close(merged.float(), full[0].float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    want = flash_decode_ref(q, kc, vc, 19).float()
    torch.testing.assert_close(merged.float(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_shard_is_flash_decode_bit_for_bit(dtype):
    """A whole cache as one shard: the partial's out is flash_decode's,
    and the merge of one shard returns it as it is."""
    rng = np.random.default_rng(4)
    tdt = DTYPES[dtype][1]
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(tdt) for shape in ((2, 8, 64), (2, 2, 48, 64),
                                           (2, 2, 48, 64)))
    for pos in (0, 30, 47, 60):
        out, m, l = flash_decode_partial(q, kc, vc, min(pos + 1, 48))
        assert torch.equal(out, flash_decode_ref(q, kc, vc, pos))
        assert merge_partials([out], [m], [l]) is out
        assert m.shape == l.shape == (2, 8) and bool((l >= 1).all())


def test_partial_statistics_are_the_softmax_max_and_sum():
    rng = np.random.default_rng(5)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((1, 4, 16), (1, 2, 8, 16), (1, 2, 8, 16)))
    _, m, l = flash_decode_partial_ref(q, kc, vc, 5)
    logits = torch.einsum("bkgd,bksd->bkgs", q.reshape(1, 2, 2, 16),
                          kc[:, :, :5]).reshape(1, 4, 5) / 4.0
    torch.testing.assert_close(m, logits.amax(-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l, torch.exp(logits - m[..., None]).sum(-1),
                               rtol=1e-6, atol=0)


def test_partial_rejects_bad_n_valid():
    q, kc = torch.zeros((1, 4, 16)), torch.zeros((1, 2, 8, 16))
    for n_valid in (-1, 9, 2.0):
        with pytest.raises(ValueError, match="n_valid"):
            flash_decode_partial(q, kc, kc, n_valid)
    with pytest.raises(ValueError):
        flash_decode_partial(torch.zeros((1, 3, 16)), kc, kc, 1)
