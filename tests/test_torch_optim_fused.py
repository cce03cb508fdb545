"""The port's grouped optimizer entries (``update_and_apply``, the leaf
tables of ops/adam_bf16_fused.py and ops/adam8_fused.py) on the CPU.

* The grouped plain chain (``tx.update_and_apply``, the masters updated in
  place) against ``tx.update`` then ``apply_updates`` over three steps:
  masters, moments, payloads and scales bit for bit, for AdamW (bf16 and
  fp32 moments, bf16 and fp32 masters, weight decay 0 and > 0) and for
  AdamW8bit (int8 and fp32-moment leaves, ragged minors).
* The leaf tables and chunk maps: every element of every leaf covered by
  exactly one chunk (320-element and misaligned leaves included), each
  record pointing at its leaf's tensors and (adam_bf16_fused, a table over
  several groups) its group, each leaf given its two salts; the merged
  table cached over both groups of a transform.
* The gradient checks of the grouped entries.

The kernels themselves run in tests/test_torch_kernels_cuda.py and
chip_smoke.py.
"""

import zlib

import numpy as np
import pytest
import torch

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.ops import adam8_fused as A8
from scal_sdt_tpu_torch.ops import adam_bf16_fused as AF
from scal_sdt_tpu_torch.training import optimizers as topt
from scal_sdt_tpu_torch.training import step as tstep

SHAPES = {"unet.a.weight": (64, 300), "unet.b.weight": (40, 48, 3, 3), "unet.c.bias": (64,),
          "unet.d.weight": (8, 16), "unet.e.bias": (7,)}


def _config(name: str, master: str, moments: str, wd: float):
    return tconf.merge(tconf.default(), tconf.Config({
        "batch_size": 2, "trainer": {"precision": "32"},
        "optimizer": {"name": name, "master_dtype": master, "moment_dtype": moments,
                      "params": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999,
                                 "weight_decay": wd, "eps": 1e-8},
                      "lr_scale": {"enabled": False}}}))


def _tensors(state):
    """Every tensor of a MultiTransform state, by (label, field, key)."""
    out = {}
    for label, s in state.items():
        for field, d in vars(s).items():
            if isinstance(d, dict):
                out.update({(label, field, k): v for k, v in d.items()})
    return out


def _run_both(name: str, master: str, moments: str, wd: float, steps: int = 3):
    """tx.update + apply_updates on one copy, tx.update_and_apply on another,
    from the same masters and gradients; returns both (masters, state)."""
    r = np.random.RandomState(17)
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[master]
    labels = {k: "g0" for k in SHAPES}
    tx, _ = topt.build_optimizer(_config(name, master, moments, wd), labels, {}, 100, 1)
    masters = {k: torch.from_numpy(r.randn(*s).astype(np.float32) * 0.3).to(dtype)
               for k, s in SHAPES.items()}
    plain = {k: v.clone() for k, v in masters.items()}
    fused = {k: v.clone() for k, v in masters.items()}
    s_plain, s_fused = tx.init(plain), tx.init(fused)
    for step in range(steps):
        grads = {k: torch.from_numpy((r.randn(*s) * 10.0 ** r.uniform(-4, 0, s))
                                     .astype(np.float32)).bfloat16() for k, s in SHAPES.items()}
        updates, s_plain = tx.update(grads, s_plain, plain)
        plain = tstep.apply_updates(plain, updates, step)
        before = {k: v for k, v in fused.items()}
        s_fused = tx.update_and_apply(grads, s_fused, fused, step)
        assert all(fused[k] is before[k] for k in fused)   # in place
    return (plain, s_plain), (fused, s_fused)


def _assert_same(plain, fused):
    (p_masters, p_state), (f_masters, f_state) = plain, fused
    for k in SHAPES:
        assert p_masters[k].dtype == f_masters[k].dtype
        assert torch.equal(p_masters[k], f_masters[k]), f"master {k}"
    pt, ft = _tensors(p_state), _tensors(f_state)
    assert pt.keys() == ft.keys() and pt
    for key in pt:
        assert pt[key].dtype == ft[key].dtype and torch.equal(pt[key], ft[key]), key
    assert [s.count for s in p_state.values()] == [s.count for s in f_state.values()] == [3]


@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["wd0", "wd"])
@pytest.mark.parametrize("master", ["bf16", "fp32"])
@pytest.mark.parametrize("moments", ["bf16", "fp32"])
def test_adamw_update_and_apply_matches_update_then_apply(moments, master, wd):
    plain, fused = _run_both("adamw", master, moments, wd)
    mu = _tensors(fused[1])[("g0", "mu", "unet.a.weight")]
    want = {"bf16": torch.bfloat16, "fp32": torch.float32}[moments]
    assert mu.dtype == (want if master == "bf16" or moments == "bf16" else torch.float32)
    _assert_same(plain, fused)


@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["wd0", "wd"])
@pytest.mark.parametrize("master", ["bf16", "fp32"])
def test_adamw8bit_update_and_apply_matches_update_then_apply(master, wd, monkeypatch):
    # leaves of 1024 elements and more take int8 moments: a ragged minor (300),
    # a 4-d leaf, and fp32-moment leaves beside them
    monkeypatch.setenv("SSDT_INT8_FUSED_MIN", "1024")
    plain, fused = _run_both("bitsandbytes.optim.AdamW8bit", master, "bf16", wd)
    assert set(fused[1]["g0"].mu_s) == {"unet.a.weight", "unet.b.weight"}
    _assert_same(plain, fused)


def test_fused_table_is_cached_and_rebuilt_for_new_tensors():
    """One table over both groups' leaves (one launch signature), kept while
    the state holds the same tensors and rebuilt for a new one."""
    labels = {k: "g0" if k < "unet.c" else "g1" for k in SHAPES}
    tx, _ = topt.build_optimizer(_config("adamw", "bf16", "bf16", 1e-2), labels,
                                 {"g1": {"lr": 3e-3}}, 100, 1)
    masters = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
    grads = {k: torch.ones(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
    state = tx.init(masters)
    state = tx.update_and_apply(grads, state, masters, 0)
    (merged,) = tx.merged_launches(state, masters)
    table = merged.table
    assert merged.labels == ["g0", "g1"] and table.keys == (
        ("unet.a.weight", "unet.b.weight"), ("unet.c.bias", "unet.d.weight", "unet.e.bias"))
    state = tx.update_and_apply(grads, state, masters, 1)
    assert merged.table is table and tx.merged_launches(state, masters) == [merged]
    masters["unet.e.bias"] = masters["unet.e.bias"].clone()
    tx.update_and_apply(grads, state, masters, 2)
    assert merged.table is not table
    assert merged.table.params[-1] is masters["unet.e.bias"]


def _covered(n: int, spans) -> np.ndarray:
    """How many times each of n elements lies in one of ``spans``."""
    hits = np.zeros(n, np.int64)
    for s, e in spans:
        hits[s:e] += 1
    return hits


def test_adam_table_covers_every_element_once():
    """A table over three groups: every element of every leaf in exactly
    one chunk, each chunk naming its leaf's group, each record pointing at
    its leaf's tensors with its two salts."""
    sizes = [1, 7, 320, 2880 * 320, AF.CHUNK, AF.CHUNK + 1, 5]
    keys = [f"unet.leaf{i}.weight" for i in range(len(sizes))]
    base = torch.zeros(sizes[-1] + 3, dtype=torch.bfloat16)
    params = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes[:-1]] + [base[3:]]  # 6 bytes off
    mu = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    nu = [torch.zeros(n, dtype=torch.float32) for n in sizes]
    cuts = [0, 2, 3, len(sizes)]      # groups of 2, 1 and 4 leaves

    groups = [keys[a:b] for a, b in zip(cuts, cuts[1:])]
    table = AF.build_adam_table(groups, params, mu, nu)
    assert table.holds(params, mu, nu) and not table.holds(params[::-1], mu, nu)
    assert not table.holds(params, nu, mu)
    assert table.keys == tuple(tuple(g) for g in groups)
    rec, chunks = table.records, table.chunks
    assert chunks.dtype == np.int32 and chunks.shape[1] == 4 and not chunks[:, 3].any()
    for i, (k, n) in enumerate(zip(keys, sizes)):
        mine = chunks[chunks[:, 0] == i, 1]
        assert list(mine) == list(range(len(mine)))   # in order, one CTA each
        hits = _covered(n, [(c * AF.CHUNK, min(n, (c + 1) * AF.CHUNK)) for c in mine])
        assert (hits == 1).all(), k
        assert len(mine) == max(1, -(-n // AF.CHUNK))
        assert (rec["p"][i], rec["mu"][i], rec["nu"][i], rec["n"][i]) == (
            params[i].data_ptr(), mu[i].data_ptr(), nu[i].data_ptr(), n)
        group = np.searchsorted(cuts, i, side="right") - 1
        assert (chunks[chunks[:, 0] == i, 2] == group).all(), k
        assert rec["nu_salt"][i] == table.nu_salts[i] == zlib.crc32(k.encode()) ^ 0xE3A0003
        assert rec["master_salt"][i] == table.master_salts[i] == zlib.crc32(k.encode()) ^ 0xE3A0001
    assert rec["p"][-1] % 16 == (base.data_ptr() + 6) % 16
    assert AF._LEAF.itemsize == 40 and AF._GROUP.itemsize == 32


@pytest.mark.parametrize("shape", [(64, 300), (320, 2880), (3, 256), (33, 301)])
def test_adam8_table_covers_every_element_once(shape):
    from scal_sdt_tpu_torch.training.quantized import _leaf_view

    lead, minor, nb = _leaf_view(shape)
    keys = ["unet.x.weight", "unet.y.weight"]
    base = torch.zeros(lead * minor + 1, dtype=torch.bfloat16)
    params = [torch.zeros(shape, dtype=torch.bfloat16), base[1:].view(shape)]  # 2 bytes off
    state = [(torch.zeros(lead, nb * A8.BLOCK, dtype=torch.int8), torch.zeros(lead, nb),
              torch.zeros(lead, nb * A8.BLOCK, dtype=torch.int8), torch.zeros(lead, nb))
             for _ in keys]
    table = A8.build_adam8_table(keys, params, state)
    assert table.holds(keys, params, state) and not table.holds(keys, params, state[::-1])
    rec, chunks = table.records, table.chunks
    for i, k in enumerate(keys):
        assert table.views[i] == (lead, minor)
        assert (rec["lead"][i], rec["minor"][i], rec["nb"][i]) == (lead, minor, nb)
        assert rec["p"][i] == params[i].data_ptr()
        assert [rec[f][i] for f in ("mu_q", "mu_s", "nu_q", "nu_s")] == [
            t.data_ptr() for t in state[i]]
        assert rec["master_salt"][i] == table.master_salts[i] == (
            zlib.crc32(k.encode()) ^ 0xE3A0001)
        mine = chunks[chunks[:, 0] == i, 1]
        assert list(mine) == list(range(len(mine)))
        # each chunk takes CHUNK_BLOCKS blocks (row-major over (lead, nb)); a
        # block covers its row's columns j*256 .. min(minor, (j+1)*256)
        spans = []
        for c in mine:
            for b in range(c * A8.CHUNK_BLOCKS, min(lead * nb, (c + 1) * A8.CHUNK_BLOCKS)):
                row, j = divmod(b, nb)
                spans.append((row * minor + j * A8.BLOCK,
                              row * minor + min(minor, (j + 1) * A8.BLOCK)))
        assert (_covered(lead * minor, spans) == 1).all(), k
    assert A8._LEAF.itemsize == 64


def test_adam8_table_refuses_state_that_does_not_fit():
    p = torch.zeros(64, 300, dtype=torch.bfloat16)
    bad = (torch.zeros(64, 256, dtype=torch.int8), torch.zeros(64, 1),
           torch.zeros(64, 256, dtype=torch.int8), torch.zeros(64, 1))
    with pytest.raises(ValueError, match="mu_q|does not fit"):
        A8.build_adam8_table(["unet.p"], [p], [bad])


def test_check_grads():
    cpu = torch.device("cpu")
    g = [torch.zeros(4, 3, dtype=torch.bfloat16).t(), torch.zeros(5, dtype=torch.bfloat16)]
    out, dtype = AF.check_grads("t", g, [12, 5], cpu)
    assert dtype == torch.bfloat16 and all(t.is_contiguous() for t in out)
    assert out[1] is g[1]
    with pytest.raises(ValueError, match="gradient 1"):
        AF.check_grads("t", g, [12, 6], cpu)
    with pytest.raises(ValueError, match="gradient 1"):
        AF.check_grads("t", [g[0], g[1].float()], [12, 5], cpu)
    with pytest.raises(ValueError, match="2 gradients for 1 leaves"):
        AF.check_grads("t", g, [12], cpu)
