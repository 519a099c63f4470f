"""Port parity of the ADME/toxicity models and the therapeutic pipeline
(molchanica_tpu_torch.models.adme, .eval, .graph_ml and
molchanica_tpu_torch.therapeutic.targets, .data, .infer, .train) against
molchanica_tpu's, on the CPU.

Tolerances:
- featurize_mol, the target labels, the dataset helpers, the metrics,
  scaffold_split and the graph features: host numpy copies, held exactly.
- AdmeModel with the flax parameters carried over by params_from_flax:
  max|d| within 1e-10 of max|out| in float64, and within 1e-5 x (1 +
  |out|) per output in float32 (other summation orders).
- Predictions through the JAX-free weights loader against the JAX
  package's TherapeuticPredictor, and compute_therapeutic_properties:
  1e-5 x (1 + |p|) (float32).
- train_adme started from the flax initialisation, 3 epochs on the same
  numpy split and shuffles, float32 on both sides: the history within
  1e-4 relative, the predictions within 1e-3 relative.
- train_target's saved file predicts the trained model's outputs bit for
  bit.

No test reads lipophilicity_astrazeneca's weights: the JAX package's own
test_train_and_infer_regression rewrites that committed file during the
run, possibly while another worker would read it.
"""
import csv
import dataclasses
import functools
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.models import adme as JA
from molchanica_tpu.models import eval as JEval
from molchanica_tpu.models import graph_ml as JG
from molchanica_tpu.molecules import smiles as JS
from molchanica_tpu.therapeutic import data as JD
from molchanica_tpu.therapeutic import infer as JI
from molchanica_tpu.therapeutic import targets as JT
from molchanica_tpu_torch.models import adme as TA
from molchanica_tpu_torch.models import eval as TEval
from molchanica_tpu_torch.models import graph_ml as TG
from molchanica_tpu_torch.molecules import smiles as TS
from molchanica_tpu_torch.therapeutic import data as TD
from molchanica_tpu_torch.therapeutic import infer as TI
from molchanica_tpu_torch.therapeutic import targets as TT
from molchanica_tpu_torch.therapeutic import train as TTrain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_WEIGHTS = os.path.join(ROOT, "molchanica_tpu", "therapeutic", "weights")
CSV_GLOB = os.path.join(ROOT, "molchanica_tpu", "therapeutic", "data",
                        "*.csv")
# rewritten by tests/test_therapeutic.py while the tests run
RACED = "lipophilicity_astrazeneca"

# tests/test_adme.py's pool
SMILES_POOL = [
    "CCO", "CCCO", "CCCCO", "CC(C)O", "CCOC", "CCOCC", "CC(=O)C",
    "CC(=O)O", "CCC(=O)O", "CC(=O)OC", "CCN", "CCCN", "CC(C)N",
    "CCNCC", "c1ccccc1", "Cc1ccccc1", "CCc1ccccc1", "Oc1ccccc1",
    "Nc1ccccc1", "Clc1ccccc1", "c1ccncc1", "Cc1ccncc1",
    "CC(=O)Nc1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "CCCCCC", "CCCCCCCC",
    "CC(C)CC(C)C", "OCC(O)CO", "NCCO", "OCCOCCO", "CSC", "CCSCC",
    "CC#N", "CCC#N", "FC(F)(F)c1ccccc1", "CCBr", "CCCl", "CCI",
    "CN(C)C", "CCN(CC)CC",
]
# 71 atoms: truncated at MAX_ATOMS = 64
VERAPAMIL = "COc1ccc(CCN(C)CCCC(C#N)(C(C)C)c2ccc(OC)c(OC)c2)cc1OC"
# the predictor tests' batches: six molecules, the size of the training
# tests' validation set, so that the JAX package's forward is compiled for
# one batch shape only
PREDICT_IDX = [14, 17, 22, 23, 39, len(SMILES_POOL)]
# the JAX package's AdmeModel.init and .apply as jitted programs, one per
# width and input shapes, shared by the tests and by both heads (the flax
# module does not read cfg.classification)
_FLAX_PROGRAMS = {}


@pytest.fixture
def jitted_flax(monkeypatch):
    """Run the JAX package's AdmeModel.init and .apply, which its
    predict_adme and train_adme call op by op, as one jitted program each:
    the same float32 arithmetic without a compile per operation."""
    for name in ("init", "apply"):
        def run(self, *args, _name=name, _orig=getattr(JA.AdmeModel, name)):
            cfg = dataclasses.replace(self.cfg, classification=False)
            fn = _FLAX_PROGRAMS.get((cfg, _name))
            if fn is None:
                fn = _FLAX_PROGRAMS[(cfg, _name)] = jax.jit(
                    functools.partial(_orig, JA.AdmeModel(cfg)))
            return fn(*args)
        monkeypatch.setattr(JA.AdmeModel, name, run)


@pytest.fixture(scope="module")
def mols():
    """(JAX molecules, port molecules) of the pool and verapamil."""
    names = SMILES_POOL + [VERAPAMIL]
    return ([JS.from_smiles(s) for s in names],
            [TS.from_smiles(s) for s in names])


@pytest.fixture(scope="module")
def labels(mols):
    """test_adme's structure-derived regression target."""
    from molchanica_tpu.molecules.characterization import characterize
    jm = mols[0][:len(SMILES_POOL)]
    return np.asarray([characterize(m).clogp + 0.05 * m.n_atoms
                       for m in jm], np.float32)


def test_featurize_matches_reference(mols):
    for jm, tm in zip(*mols):
        fj, ft = JA.featurize_mol(jm), TA.featurize_mol(tm)
        assert len(ft) == 7
        for a, b in zip(fj, ft):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    ver = mols[1][-1]
    assert ver.n_atoms == 71
    assert TA.featurize_mol(ver)[2].sum() == TA.MAX_ATOMS


def _committed(target):
    assert target != RACED
    return os.path.join(REF_WEIGHTS, f"{target}.pkl")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_model_matches_flax(mols, dtype):
    blob = TA.load_reference_pickle(_committed("caco2_wang"))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                    blob["params"])
    feats = [f.astype(dtype) for f in TA.featurize_batch(mols[1])]
    ref = np.asarray(jax.jit(JA.AdmeModel(blob["cfg"]).apply)(
        jax.tree_util.tree_map(jnp.asarray, params),
        *(jnp.asarray(f) for f in feats)))
    model = TA.build_model(blob["cfg"], TA.params_from_flax(params), "cpu")
    out = TA.adme_forward(model, feats)
    assert out.dtype == np.dtype(dtype) and out.shape == ref.shape
    err = np.abs(out.astype(np.float64) - ref)
    if dtype == "float64":
        assert err.max() <= 1e-10 * np.abs(ref).max(), err.max()
    else:
        assert (err <= 1e-5 * (1.0 + np.abs(ref))).all(), err.max()


@pytest.mark.parametrize("target", ["caco2_wang", "hia_hou"])
def test_predict_through_loader_matches_reference(mols, target,
                                                  jitted_flax):
    ref = JI.TherapeuticPredictor(target, _committed(target))
    pred = TI.TherapeuticPredictor(target, _committed(target), device="cpu")
    assert pred.cfg == TA.AdmeModelConfig(
        classification=ref.cfg.classification)
    assert (pred.scaler.mean, pred.scaler.std) == (ref.scaler.mean,
                                                   ref.scaler.std)
    assert pred.metrics == ref.metrics
    assert pred.label_source == ref.label_source == "measured"
    p_ref = ref.predict_mols([mols[0][i] for i in PREDICT_IDX])
    p = pred.predict_mols([mols[1][i] for i in PREDICT_IDX])
    assert p.shape == p_ref.shape
    assert (np.abs(p - p_ref) <= 1e-5 * (1.0 + np.abs(p_ref))).all()
    p_adme = TA.predict_adme(pred.model.state_dict(),
                             [mols[1][i] for i in PREDICT_IDX], pred.scaler,
                             pred.cfg, device="cpu")
    np.testing.assert_array_equal(p, p_adme)


def test_loader_refuses_other_globals(tmp_path):
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        TA.load_reference_pickle(path)


@pytest.mark.parametrize("classification,batch_size",
                         [(False, 16), (True, 64)],
                         ids=["regression", "classification-short-batch"])
def test_train_adme_matches_reference_from_its_init(mols, labels,
                                                    classification,
                                                    batch_size, jitted_flax):
    jm, tm = mols[0][:len(labels)], mols[1][:len(labels)]
    y = labels if not classification \
        else (labels > np.median(labels)).astype(np.float32)
    cfg_j = JA.AdmeModelConfig(classification=classification)
    cfg_t = TA.AdmeModelConfig(classification=classification)
    seed = 3
    # the initialisation JA.train_adme draws (it depends on the key and
    # the input shapes only; one program for both heads)
    first = [jnp.asarray(f[:1]) for f in TA.featurize_batch(tm[:1])]
    init = JA.AdmeModel(cfg_j).init(jax.random.PRNGKey(seed), *first)
    init = jax.tree_util.tree_map(np.asarray, init)
    kw = dict(n_epochs=3, batch_size=batch_size, seed=seed)
    p_j, sc_j, h_j = JA.train_adme(jm, y, cfg=cfg_j, **kw)
    state, sc_t, h_t = TA.train_adme(
        tm, y, cfg=cfg_t, device="cpu",
        init_state=TA.params_from_flax(init), **kw)
    assert (sc_t.mean, sc_t.std) == (sc_j.mean, sc_j.std)
    assert [e for e, _, _ in h_t] == [e for e, _, _ in h_j] == [0, 1, 2]
    np.testing.assert_allclose(np.asarray(h_t)[:, 1:],
                               np.asarray(h_j)[:, 1:], rtol=1e-4)
    # JA.predict_adme's forward
    raw_j = JA.AdmeModel(cfg_j).apply(
        p_j, *(jnp.asarray(f) for f in TA.featurize_batch(tm)))
    pred_j = TA.postprocess(np.asarray(raw_j), sc_j, cfg_t)
    pred_t = TA.predict_adme(state, tm, sc_t, cfg_t, device="cpu")
    np.testing.assert_allclose(pred_t, pred_j, rtol=1e-3)


def test_port_init_is_flax_lecun_normal():
    sd = TA.init_params(TA.AdmeModelConfig(),
                        torch.Generator().manual_seed(0))
    # the flax module's parameter tree, traced without running its init
    ref = jax.eval_shape(
        JA.AdmeModel().init, jax.random.PRNGKey(0),
        *(jnp.zeros((1,) + s, jnp.float32) for s in (
            (64, 16), (4, 64, 64), (64,), (40,), (12, 12), (12, 12),
            (12,))))
    ref = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), ref)
    ref = TA.params_from_flax(ref)
    assert sd.keys() == ref.keys()
    for k, v in sd.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype
        if k.endswith("bias"):
            assert not v.any()
        elif "norm" in k:
            assert (v == 1).all()
        else:
            std = (1.0 / v.shape[1]) ** 0.5 / 0.87962566103423978
            assert v.abs().max() <= 2 * std
            assert 0.7 < float(v.std()) * v.shape[1] ** 0.5 < 1.3


def test_train_target_round_trip(mols, labels, tmp_path):
    csv_path = tmp_path / "measured.csv"
    with open(csv_path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["smiles", "y"])
        for s, v in zip(SMILES_POOL[:24], labels[:24]):
            w.writerow([s, float(v)])
    out = TTrain.train_target("logp_experimental", csv=str(csv_path),
                              n_epochs=2, weights_dir=str(tmp_path),
                              device="cpu")
    path = out["weights_path"]
    assert path == str(tmp_path / "logp_experimental.pt")
    assert len(out["history"]) == 2 and out["history_tail"] == \
        out["history"][-3:]
    blob = torch.load(path, weights_only=True)
    assert blob["target"] == "logp_experimental"
    assert blob["metrics"] == out["metrics"]
    pred = TI.TherapeuticPredictor("logp_experimental", weights_path=path,
                                   device="cpu")
    assert pred.label_source == "measured"
    _, _, te = TD.split_dataset(24, seed=0)
    p = pred.predict_mols([mols[1][i] for i in te])
    np.testing.assert_array_equal(p, out["test_pred"])
    # the default lies in the port's package, never in the reference's
    pkg = os.path.dirname(os.path.abspath(TTrain.__file__))
    assert TTrain.WEIGHTS_DIR == os.path.join(pkg, "weights")


def test_targets_match_reference(mols):
    assert {n: s.classification for n, s in TT.TARGETS.items()} == \
        {n: s.classification for n, s in JT.TARGETS.items()}
    assert TT.EXPERIMENTAL_DATA == JT.EXPERIMENTAL_DATA
    for name in TT.TARGETS:
        np.testing.assert_array_equal(
            TT.compute_labels(TT.TARGETS[name], mols[1]),
            JT.compute_labels(JT.TARGETS[name], mols[0]))
    for rel in TT.EXPERIMENTAL_DATA.values():
        assert os.path.exists(os.path.join(TT.REFERENCE_DIR, rel))


def test_data_matches_reference():
    assert TD.builtin_smiles(6) == JD.builtin_smiles(6)
    for path in sorted(glob.glob(CSV_GLOB)):
        s_t, y_t = TD.load_csv_dataset(path)
        s_j, y_j = JD.load_csv_dataset(path)
        assert s_t == s_j
        np.testing.assert_array_equal(y_t, y_j)
    for n, seed in ((100, 1), (99, 0), (40, 7)):
        for a, b in zip(TD.split_dataset(n, seed=seed),
                        JD.split_dataset(n, seed=seed)):
            np.testing.assert_array_equal(a, b)


def test_eval_matches_reference(mols):
    rng = np.random.default_rng(5)
    y = rng.normal(size=50)
    p = y + rng.normal(scale=0.5, size=50)
    yb = (y > 0).astype(float)
    assert TEval.evaluate(y, p) == JEval.evaluate(y, p)
    assert TEval.evaluate(yb, p, classification=True) == \
        JEval.evaluate(yb, p, classification=True)
    assert TEval.auroc(yb, np.round(p)) == JEval.auroc(yb, np.round(p))
    for seed in (0, 1):
        assert TEval.scaffold_split(mols[1], 0.25, seed) == \
            JEval.scaffold_split(mols[0], 0.25, seed)


def test_graph_ml_matches_reference(mols):
    for jm, tm in zip(*mols):
        np.testing.assert_array_equal(TG.atom_graph_analysis_features(tm),
                                      JG.atom_graph_analysis_features(jm))
    a, b = mols[1][-1], mols[1][23]
    ja, jb = mols[0][-1], mols[0][23]
    assert TG.wl_kernel(a.adjacency(), a.elements, b.adjacency(),
                        b.elements) == \
        JG.wl_kernel(ja.adjacency(), ja.elements, jb.adjacency(),
                     jb.elements)
    x = np.asarray(a.positions)
    d = np.linalg.norm(x[:, None] - x[None], axis=-1)
    assert TG.build_spatial_adj(d) == JG.build_spatial_adj(d)


def test_infer_groups_match_reference(jitted_flax):
    assert TI._FIELD_MAP == JI._FIELD_MAP
    for t_cls, j_cls in ((TI.Adme, JI.Adme), (TI.Toxicity, JI.Toxicity)):
        assert [f.name for f in dataclasses.fields(t_cls)] == \
            [f.name for f in dataclasses.fields(j_cls)]
    targets = ["caco2_wang", "herg"]
    assert RACED not in targets
    assert set(targets) <= set(TI.TherapeuticPredictor.available())
    smiles = [(SMILES_POOL + [VERAPAMIL])[i] for i in PREDICT_IDX]
    got = TI.compute_therapeutic_properties(smiles, targets, device="cpu")
    ref = JI.compute_therapeutic_properties(smiles, targets)
    for g, r in zip(got, ref):
        for group, vals in r.as_dict().items():
            for k, v in vals.items():
                u = g.as_dict()[group][k]
                assert np.isnan(u) == np.isnan(v), k
                if not np.isnan(v):
                    assert abs(u - v) <= 1e-5 * (1.0 + abs(v)), (k, u, v)


def test_entry_points_need_the_card(mols, labels):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.TherapeuticPredictor("caco2_wang")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.train_adme(mols[1][:8], labels[:8], n_epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.predict_adme(TA.init_params(TA.AdmeModelConfig(),
                                       torch.Generator()), mols[1][:2])
