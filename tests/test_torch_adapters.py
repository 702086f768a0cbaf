"""Port adapters (``repro_torch.adapters``) against the JAX package.

A delta extracted by the JAX package applies in the port bit for bit
(the same rows as JAX's ``apply_delta``), revert is bit-exact, the
structural fingerprints agree, and registry directories written by
either package load in the other, payload checksum and all.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adapters import AdapterRegistry as JRegistry
from repro.adapters import apply_delta as japply
from repro.adapters import extract_delta as jextract
from repro.adapters import fingerprint as jfingerprint
from repro.adapters import quantize_delta as jquantize
from repro.adapters.testing import perturb_rows as jperturb
from repro.checkpoint.checkpointer import _flatten_with_names as jflat
from repro.models import model as jmodel
from repro_torch import adapters as tad
from repro_torch import interop
from repro_torch.adapters.testing import perturb_rows
from repro_torch.checkpoint import checkpointer as tckpt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jparams(tiny_cfg):
    return jmodel.init_params(jax.random.PRNGKey(0), tiny_cfg)


def _port(tree):
    return interop.tree_to_torch(jax.tree.map(np.asarray, tree),
                                 device="cpu")


def _port_delta(jd):
    """A JAX SparseDelta as the port's (host arrays -> CPU tensors)."""
    return tad.SparseDelta(
        {n: tad.DeltaEntry(idx=e.idx, rows=np.asarray(e.rows))
         for n, e in jd.entries.items()}, dict(jd.meta))


def _same_bits(port_tree, jax_tree):
    got = interop.named_numpy(port_tree)
    names, leaves, _ = jflat(jax_tree)
    assert list(got) == names
    for n, leaf in zip(names, leaves):
        assert got[n].tobytes() == np.asarray(leaf).tobytes(), n


@pytest.mark.parametrize("leaf", [None, "final_norm"])
def test_jax_delta_applies_bitwise_and_reverts(jparams, leaf):
    tuned = jperturb(jparams, rows=(1, 3), seed=0, leaf=leaf)
    jd = jextract(jparams, tuned)
    want, _ = japply(jparams, jd)
    base = _port(jparams)
    snapshot = tad.copy_tree(base)
    new, displaced = tad.apply_delta(base, _port_delta(jd))
    _same_bits(new, want)
    _same_bits(base, jparams)                   # not donated: untouched
    back = tad.revert_delta(new, displaced, donate=True)
    _same_bits(back, jparams)
    names, leaves, _ = tckpt._flatten_with_names(back)
    for (n, a), b in zip(zip(names, leaves),
                         tckpt._flatten_with_names(snapshot)[1]):
        assert torch.equal(a, b), n


def test_port_extract_equals_jax_extract(jparams):
    tuned = jperturb(jparams, rows=(2, 3), seed=1)
    jd = jextract(jparams, tuned)
    td = tad.extract_delta(_port(jparams), _port(tuned))
    assert sorted(td.entries) == sorted(jd.entries)
    for n, e in jd.entries.items():
        assert np.array_equal(td.entries[n].idx.numpy(), e.idx)
        assert td.entries[n].rows.numpy().tobytes() == \
            np.asarray(e.rows).tobytes()
    assert td.meta["base_fingerprint"] == jd.meta["base_fingerprint"]
    assert td.nbytes == jd.nbytes


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fingerprint_equal_across_packages(tiny_cfg, dtype):
    jp = jmodel.init_params(jax.random.PRNGKey(0), tiny_cfg, dtype=dtype)
    assert tad.fingerprint(_port(jp)) == jfingerprint(jp)


def test_perturb_rows_same_draws_as_jax(jparams):
    want = jperturb(jparams, rows=(1, 3), seed=4, leaf="final_norm")
    _same_bits(perturb_rows(_port(jparams), rows=(1, 3), seed=4,
                            leaf="final_norm"), want)
    # rows past the stack are dropped, as JAX's scatter drops them
    want = jperturb(jparams, rows=(2, 9), seed=5)
    _same_bits(perturb_rows(_port(jparams), rows=(2, 9), seed=5), want)


def test_jax_registry_loads_in_port_and_back(jparams, tmp_path):
    jreg = JRegistry(tmp_path / "reg")
    tuned = jperturb(jparams, rows=(1, 3), seed=2)
    jreg.put("a", jextract(jparams, tuned))
    treg = tad.AdapterRegistry(tmp_path / "reg")
    assert treg.list_adapters() == ["a"]
    d = treg.acquire("a")                        # checksum verified
    new, _ = tad.apply_delta(_port(jparams), d)
    _same_bits(new, japply(jparams, jreg.get("a"))[0])
    treg.release("a")
    # the port writes the same format: JAX reads it, checksum and all
    treg.put("b", tad.extract_delta(_port(jparams), _port(tuned)))
    jd = JRegistry(tmp_path / "reg").get("b")
    assert jd.meta["payload_sha256"] == d.meta["payload_sha256"]


def test_corrupt_payload_and_quantized_delta(jparams, tmp_path):
    tuned = jperturb(jparams, rows=(1, 3), seed=3)
    td = tad.extract_delta(_port(jparams), _port(tuned))
    path = tad.save_delta(tmp_path / "d", td)
    loaded = tad.load_delta(path)
    for n, e in td.entries.items():
        assert torch.equal(loaded.entries[n].rows, e.rows)
    arrays = dict(np.load(path / "arrays.npz"))
    arrays["a1"] = arrays["a1"] + 1.0
    np.savez(path / "arrays.npz", **arrays)
    with pytest.raises(tad.AdapterCorruptError):
        tad.load_delta(path)
    # Q8 payloads written by JAX load, but applying one is not ported
    jq = jquantize(jextract(jparams, tuned))
    JRegistry(tmp_path / "q").put("q", jq)
    q = tad.AdapterRegistry(tmp_path / "q").get("q")
    assert q.quantized
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tad.apply_delta(_port(jparams), q)


def test_bf16_payload_round_trip(tmp_path):
    named = {"w": torch.randn(3, 5).bfloat16(),
             "i": torch.arange(4, dtype=torch.int32)}
    tckpt.write_payload(tmp_path / "p", named, meta={"x": 1})
    got, manifest = tckpt.read_payload(tmp_path / "p")
    assert manifest["meta"] == {"x": 1}
    assert [e["dtype"] for e in manifest["leaves"]] == ["bfloat16", "int32"]
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), named["w"].view(torch.int16))
    assert torch.equal(got["i"], named["i"])
