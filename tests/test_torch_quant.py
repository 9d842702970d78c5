"""int8 serving: the port's ``ops/quant.py`` and quant gate against JAX.

The same numpy-drawn EEGNet variables go to both packages (the port's
through ``from_jax_variables``).  The quantized arrays and
``qparams_digest`` must be bit-equal, a ``save_quantized`` file of either
package must load in the other, the int8 forward must agree with the JAX
``quantized_eval_forward`` within atol 1e-5 / rtol 1e-4 (only the order of
f32 sums differs) with equal argmax, and the quant gate must give the JAX
gate's per-subject agreement on an explicit gate set.  The synthetic gate
set of ``default_gate_set`` must be the JAX package's bytes.
"""

import numpy as np
import pytest
import torch
from torch_port_cases import (
    GEOMETRIES,
    jax_model,
    jax_variables,
    port_model,
    trials,
)

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.ops import quant
from eegnetreplication_tpu_torch.serve import engine as port_engine

ATOL, RTOL = 1e-5, 1e-4


def _walk_pairs(a, b, path=()):
    if hasattr(a, "items"):
        assert set(a) == set(b), path
        for k in a:
            yield from _walk_pairs(a[k], b[k], path + (k,))
    else:
        yield path, a, b


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("stacked", [False, True], ids=["one", "stacked"])
def test_quantized_arrays_and_digest_are_bit_equal(geometry, stacked):
    from eegnetreplication_tpu.ops import quant as jax_quant
    from eegnetreplication_tpu.ops import stacked as jax_stacked

    params, _ = jax_variables(*GEOMETRIES[geometry], seed=3)
    if stacked:
        params = jax_stacked.stack_trees(
            [params] + [jax_variables(*GEOMETRIES[geometry], seed=s)[0]
                        for s in (4, 5)])
    want = jax_quant.quantize_params(params, stacked=stacked)
    got = quant.quantize_params(params, stacked=stacked)
    for path, g, w in _walk_pairs(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path
    assert quant.qparams_digest(got) == jax_quant.qparams_digest(want)
    assert quant.quantization_error(params, got) == \
        jax_quant.quantization_error(params, want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_quantized_files_cross_load(writer, tmp_path):
    from eegnetreplication_tpu.ops import quant as jax_quant

    params, _ = jax_variables(*GEOMETRIES["product"], seed=6)
    qp = quant.quantize_params(params)
    saver, loader = ((quant.save_quantized, jax_quant.load_quantized)
                     if writer == "port" else
                     (jax_quant.save_quantized, quant.load_quantized))
    path = saver(tmp_path / "q.npz", qp, {"model": "eegnet"})
    back, meta = loader(path)
    assert meta == {"model": "eegnet"}
    assert quant.qparams_digest(back) == quant.qparams_digest(qp)


def test_a_corrupt_quantized_file_is_refused(tmp_path):
    params, _ = jax_variables(*GEOMETRIES["small"], seed=7)
    path = quant.save_quantized(tmp_path / "q.npz",
                                quant.quantize_params(params))
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    flat["qparams/classifier/bias"] = flat["qparams/classifier/bias"] + 1
    np.savez(tmp_path / "bad.npz", **flat)
    with pytest.raises(ValueError, match="digest"):
        quant.load_quantized(tmp_path / "bad.npz")


@pytest.mark.parametrize("geometry", ["product", "wide"])
@pytest.mark.parametrize("batch", [1, 8])
def test_int8_forward_matches_jax(geometry, batch):
    import jax.numpy as jnp

    from eegnetreplication_tpu.ops import quant as jax_quant

    c, t, f1, d = GEOMETRIES[geometry]
    params, stats = jax_variables(c, t, f1, d, seed=8)
    qp = jax_quant.quantize_params(params)
    x = trials(batch, c, t, seed=9)
    want = np.asarray(jax_quant.quantized_eval_forward(
        jax_model(c, t, f1, d), qp, stats, jnp.asarray(x)))
    pack = quant.fold_quantized_eegnet(quant.quantize_params(params), stats)
    got = quant.quantized_eval_forward(pack, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    plain = quant.quantized_eval_forward_reference(
        pack, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(plain, got)   # the CPU path IS the plain one


def test_int8_engine_serves_the_int8_forward():
    c, t, f1, d = GEOMETRIES["product"]
    params, stats = jax_variables(c, t, f1, d, seed=10)
    model = port_model(params, stats, c, t, f1, d)
    engine = port_engine.InferenceEngine(model, (1, 8), device="cpu",
                                         precision="int8")
    fp32 = port_engine.InferenceEngine(model, (1, 8), device="cpu")
    assert engine.digest == fp32.digest
    assert engine.quantized_digest == quant.qparams_digest(
        quant.quantize_params(params))
    x = trials(11, c, t, seed=11)
    pack = quant.fold_quantized_eegnet(quant.quantize_params(params), stats)
    want = quant.quantized_eval_forward(pack, torch.from_numpy(x)).argmax(-1)
    np.testing.assert_array_equal(engine.infer(x), want.numpy())


def test_default_gate_set_is_the_jax_synthetic_set(tmp_path, monkeypatch):
    from eegnetreplication_tpu.serve import engine as jax_engine

    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    got_src, got = port_engine.default_gate_set(22, 257)
    want_src, want = jax_engine.default_gate_set(22, 257)
    assert got_src == want_src == "synthetic"
    assert [name for name, _ in got] == [name for name, _ in want]
    assert got[0][1].tobytes() == np.asarray(want[0][1]).tobytes()


def test_default_gate_set_reads_processed_eval_sessions(tmp_path,
                                                        monkeypatch):
    from torch_port_cases import write_processed_tree

    write_processed_tree(tmp_path, subjects=(1, 3))
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    source, subjects = port_engine.default_gate_set(4, 64)
    assert source == "bci_iv_2a_eval"
    assert [name for name, _ in subjects] == ["A01E", "A03E"]
    assert port_engine.default_gate_set(22, 257)[0] == "synthetic"


@pytest.fixture(scope="module")
def gate_case():
    """A product-width model and an explicit 32-trial, 2-subject gate set
    on which int8 and fp32 disagree on one trial of subject 1 (seed 35 is
    the first of seeds 12-59 to give a near-tie), so the per-subject
    agreement is a real number to compare and the default floor refuses."""
    c, t, f1, d = GEOMETRIES["product"]
    params, stats = jax_variables(c, t, f1, d, seed=35)
    gate_set = [("A01E", trials(16, c, t, seed=13)),
                ("A02E", trials(16, c, t, seed=14))]
    return params, stats, gate_set


def test_quant_gate_gives_the_jax_agreement(gate_case, tmp_path):
    from eegnetreplication_tpu.serve import engine as jax_engine

    params, stats, gate_set = gate_case
    c, t, f1, d = GEOMETRIES["product"]
    jmodel = jax_model(c, t, f1, d)
    want = jax_engine.run_quant_gate(
        jax_engine.InferenceEngine(jmodel, params, stats, (8,)),
        jax_engine.InferenceEngine(jmodel, params, stats, (8,),
                                   precision="int8"), gate_set)
    model = port_model(params, stats, c, t, f1, d)
    with obs_journal.run(tmp_path / "obs") as journal:
        got = port_engine.run_quant_gate(
            port_engine.InferenceEngine(model, (8,), device="cpu"),
            port_engine.InferenceEngine(model, (8,), device="cpu",
                                        precision="int8"), gate_set)
    assert got.per_subject == want.per_subject == {"A01E": 0.9375,
                                                   "A02E": 1.0}
    assert got.agreement == want.agreement and got.outcome == want.outcome
    events = [e for e in obs_journal.schema.read_events(
        journal.events_path) if e["event"] == "quant_gate"]
    assert len(events) == 1 and events[0]["outcome"] == got.outcome


@pytest.mark.parametrize("floor, served", [
    (0.9, "int8"), (port_engine.QUANT_AGREEMENT_FLOOR, "fp32")])
def test_gated_builder_serves_int8_on_a_pass_and_fp32_on_a_refusal(
        gate_case, floor, served):
    params, stats, gate_set = gate_case
    model = port_model(params, stats, *GEOMETRIES["product"])
    engine, gate = port_engine.build_gated_engine(
        model, (8,), precision="int8", floor=floor, gate_set=gate_set,
        warm=False, device="cpu")
    assert engine.precision == served
    assert gate.passed == (served == "int8")
    fp32, none = port_engine.build_gated_engine(model, (8,), warm=False,
                                                device="cpu")
    assert none is None and fp32.precision == "fp32"
    with pytest.raises(ValueError, match="precision"):
        port_engine.build_gated_engine(model, (8,), precision="int4",
                                       device="cpu")
