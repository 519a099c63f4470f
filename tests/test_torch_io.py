"""Port parity of the structure and trajectory files (molchanica_tpu_torch.io)
against molchanica_tpu.io: every writer, every reader, open_file's dispatch
and the Amber prmtop / inpcrd readers.

Inputs are made from a seed with numpy and given to both packages. The
port's modules are copies of the reference's host code, so the bar is
exact: every writer's bytes equal the JAX package's (XTC's bit stream at
precisions 100, 1000 and 10000, on a compressed frame and on a frame of
at most 9 atoms); every port reader reads the JAX writer's file to equal
arrays (np.array_equal, dtype included) and fields, and the JAX reader
reads the port's file the same way; every MolSpec field of read_prmtop
equals the reference's.
"""
import dataclasses

import numpy as np
import pytest

from molchanica_tpu import io as J
from molchanica_tpu.io import mmcif as JMmcif
from molchanica_tpu.io import prmtop as JPrm
from molchanica_tpu.io import trr as JTrr
from molchanica_tpu.io import xtc as JXtc
from molchanica_tpu.molecules.common import MoleculeCommon as JMol
from molchanica_tpu_torch import io as T
from molchanica_tpu_torch.io import xtc as TXtc
from molchanica_tpu_torch.io.gro import read_gro_trajectory
from molchanica_tpu_torch.molecules.common import MoleculeCommon as TMol
from test_prmtop import _fixture_text

ETHANOL = ["C", "C", "O", "H", "H", "H", "H", "H", "H"]
BONDS = [(0, 1), (1, 2), (0, 3), (0, 4), (0, 5), (1, 6), (1, 7), (2, 8)]


def same(a, b, where="value"):
    """Exact equality of two readers' outputs: arrays by value and dtype,
    sequences and dataclasses (of either package) field by field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{k}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _mols(seed=0, n_rep=3):
    """The same molecule in both packages: ethanol copies jittered from the
    seed, with charges, formal charges, names, residues, chains and
    hetero flags (one atom name with a quote, as mmCIF must quote it)."""
    rng = np.random.default_rng(seed)
    base = np.array([
        [0.0, 0.0, 0.0], [1.53, 0.0, 0.0], [2.0, 1.3, 0.0],
        [-0.4, 1.0, 0.0], [-0.4, -0.5, 0.9], [-0.4, -0.5, -0.9],
        [1.9, -0.5, 0.9], [1.9, -0.5, -0.9], [2.9, 1.3, 0.2]])
    pos = np.concatenate([base + [6.0 * r, 0.0, 0.0] for r in range(n_rep)])
    pos = pos + rng.normal(0.0, 0.3, pos.shape)
    n = len(pos)
    kw = dict(
        elements=ETHANOL * n_rep, positions=pos,
        bonds=[(a + 9 * r, b + 9 * r) for r in range(n_rep)
               for a, b in BONDS],
        bond_orders=[1.0, 2.0, 1.5, 1.0, 1.0, 1.0, 1.0, 1.0] * n_rep,
        atom_names=[f"{e}{i + 1}" for i, e in enumerate(ETHANOL * n_rep)],
        res_names=["ETH"] * n, res_ids=[1 + i // 9 for i in range(n)],
        chains=["A"] * 9 + ["B"] * (n - 9),
        charges=rng.uniform(-0.5, 0.5, n),
        formal_charges=[0, 0, -1] + [0] * (n - 3),
        name="ethanols", hetero=[i % 2 == 0 for i in range(n)])
    kw["atom_names"][4] = "H5'"
    return JMol(**kw), TMol(**kw)


def _write(tmp_path, ext, jwrite, twrite):
    """Both packages' files for one writer; their bytes must be equal."""
    pj, pt = tmp_path / f"j{ext}", tmp_path / f"t{ext}"
    jwrite(pj)
    twrite(pt)
    bj, bt = pj.read_bytes(), pt.read_bytes()
    assert len(bj) > 0 and bj == bt
    return pj, pt


def _read_both(pj, pt, jread, tread):
    """The port reader on the JAX file and the JAX reader on the port's
    file, each equal to the JAX reader on the JAX file (read_mmcif names
    the molecule by its path, which is set aside)."""
    def read(fn, p):
        m = fn(p)
        if getattr(m, "name", None) == str(p):
            m.name = "<path>"
        return m

    ref = read(jread, pj)
    same(read(tread, pj), ref, "port reader")
    same(read(jread, pt), ref, "jax reader")
    return ref


STRUCTURES = {
    "sdf": (".sdf", lambda m, p, W: W.write_sdf(m, p), "read_sdf"),
    "mol2": (".mol2", lambda m, p, W: W.write_mol2(m, p), "read_mol2"),
    "pdb": (".pdb", lambda m, p, W: W.write_pdb(m, p), "read_pdb"),
    "xyz": (".xyz", lambda m, p, W: W.write_xyz(m, p, comment="seed"),
            "read_xyz"),
    "gro_mol": (".gro", lambda m, p, W: W.write_gro(
        p, m, box_extent=np.array([20.0, 22.0, 24.0])), "read_gro"),
    "mmcif": (".cif", lambda m, p, W: W.write_mmcif(m, p, entry_id="ETH3"),
              "read_mmcif"),
}


@pytest.mark.parametrize("fmt", sorted(STRUCTURES))
def test_structure_writer_and_reader(fmt, tmp_path):
    """Each structure writer's bytes and each reader's fields, both
    directions."""
    ext, write, reader = STRUCTURES[fmt]
    jm, tm = _mols(seed=1)
    Jw = JMmcif if fmt == "mmcif" else J
    pj, pt = _write(tmp_path, ext, lambda p: write(jm, p, Jw),
                    lambda p: write(tm, p, T))
    jread = getattr(Jw, reader)
    ref = _read_both(pj, pt, jread, getattr(T, reader))
    mol = ref[0] if fmt == "gro_mol" else ref
    assert mol.n_atoms == jm.n_atoms


def test_gro_arrays_with_velocities(tmp_path):
    """write_gro from raw arrays with velocities and residue fields."""
    rng = np.random.default_rng(2)
    n = 14
    x = rng.uniform(0.0, 30.0, (n, 3))
    v = rng.normal(0.0, 3.0, (n, 3))
    kw = dict(positions=x, box_extent=np.array([30.0, 31.0, 32.0]),
              atom_names=[f"A{i}" for i in range(n)],
              res_names=["SOL"] * n, res_ids=[i // 3 + 1 for i in range(n)],
              velocities=v, title="seeded")
    els = ["O", "H", "H"] * 4 + ["Cl", "Na"]
    pj, pt = _write(tmp_path, ".gro", lambda p: J.write_gro(p, els, **kw),
                    lambda p: T.write_gro(p, els, **kw))
    _read_both(pj, pt, J.read_gro, T.read_gro)


def test_gro_trajectory(tmp_path):
    """write_gro_trajectory's bytes; the port's read_gro_trajectory reads
    every frame back within the format's 3 decimals in nm, and its first
    frame equals read_gro's."""
    from molchanica_tpu.io.gro import write_gro_trajectory as jw
    rng = np.random.default_rng(3)
    els = ["O", "H", "H"] * 5
    frames = rng.uniform(0.0, 25.0, (4, 15, 3))
    box = np.array([25.0, 25.0, 26.0])
    pj, pt = _write(tmp_path, ".gro",
                    lambda p: jw(p, els, frames, box),
                    lambda p: T.write_gro_trajectory(p, els, frames, box))
    back, boxes = read_gro_trajectory(pt)
    assert back.shape == frames.shape and boxes.shape == (4, 3)
    np.testing.assert_allclose(back, frames, rtol=0, atol=5e-3 + 1e-9)
    np.testing.assert_allclose(boxes, np.tile(box, (4, 1)), rtol=0,
                               atol=5e-5)
    first, box0 = J.read_gro(pj)
    assert np.array_equal(back[0], first.positions)
    assert np.array_equal(boxes[0], box0)


@pytest.mark.parametrize("with_box", [True, False])
def test_dcd(with_box, tmp_path):
    rng = np.random.default_rng(4)
    frames = rng.uniform(0.0, 30.0, (5, 17, 3)).astype(np.float32)
    box = np.array([30.0, 31.0, 32.0]) if with_box else None
    kw = dict(box_extent=box, dt_ps=0.001, save_interval=10)
    pj, pt = _write(tmp_path, ".dcd", lambda p: J.write_dcd(p, frames, **kw),
                    lambda p: T.write_dcd(p, frames, **kw))
    f2, cells = _read_both(pj, pt, J.read_dcd, T.read_dcd)
    assert np.array_equal(f2, frames)
    assert (cells is None) == (not with_box)


def _trr_frames(mod, double, seed=5):
    rng = np.random.default_rng(seed)
    return [mod.TrrFrame(
        step=100 * k, time_ps=0.2 * k,
        box_extent=np.array([25.0, 26.0, 27.0]) if k != 1 else None,
        positions=rng.uniform(0.0, 25.0, (11, 3)),
        velocities=rng.normal(0.0, 5.0, (11, 3)) if k != 2 else None,
        forces=rng.normal(0.0, 50.0, (11, 3)) if double else None,
        lam=0.25 * k) for k in range(4)]


@pytest.mark.parametrize("double", [False, True])
def test_trr(double, tmp_path):
    """Single and double precision, frames with and without a box,
    velocities and forces."""
    jf = _trr_frames(JTrr, double)
    tf = _trr_frames(T, double)
    pj, pt = _write(tmp_path, ".trr",
                    lambda p: JTrr.write_trr(jf, p, double=double),
                    lambda p: T.write_trr(tf, p, double=double))
    assert JTrr.write_trr(jf, double=double) == pj.read_bytes()
    back = _read_both(pj, pt, JTrr.read_trr, T.read_trr)
    assert [f.step for f in back] == [0, 100, 200, 300]
    same(T.read_trr(pt.read_bytes()), back, "bytes input")


def _xtc_frames(mod, n_atoms, seed):
    rng = np.random.default_rng(seed)
    return [mod.XtcFrame(
        step=10 * k, time_ps=0.002 * k,
        box_extent=np.array([28.0, 30.0, 32.0]) if k != 2 else None,
        positions=rng.uniform(-3.0, 30.0, (n_atoms, 3)))
        for k in range(4)]


@pytest.mark.parametrize("n_atoms", [150, 9])
@pytest.mark.parametrize("precision", [100.0, 1000.0, 10000.0])
def test_xtc(precision, n_atoms, tmp_path):
    """The compressed stream (150 atoms) and the uncompressed branch of a
    frame of at most 9 atoms, at each precision: the same bytes, and the
    same frames read back by both readers; positions within 0.5 /
    precision nm of the written ones on the compressed path."""
    jf = _xtc_frames(JXtc, n_atoms, seed=int(precision) + n_atoms)
    tf = _xtc_frames(T, n_atoms, seed=int(precision) + n_atoms)
    pj, pt = _write(tmp_path, ".xtc",
                    lambda p: JXtc.write_xtc(jf, p, precision=precision),
                    lambda p: T.write_xtc(tf, p, precision=precision))
    back = _read_both(pj, pt, JXtc.read_xtc, T.read_xtc)
    same(T.read_xtc(pt.read_bytes()), back, "bytes input")
    tol = 1e-5 if n_atoms <= 9 else 10.0 * 0.5 / precision + 1e-6
    for a, b in zip(tf, back):
        np.testing.assert_allclose(b.positions, a.positions, rtol=0,
                                   atol=tol)
        assert (b.box_extent is None) == (a.box_extent is None)


def test_xtc_bit_writer():
    """_sizeofints and _encodeints on mixed radices up to 2^72 give the
    reference's bits."""
    rng = np.random.default_rng(6)
    for _ in range(50):
        sizes = [int(s) for s in rng.integers(2, 1 << 24, 3)]
        vals = [int(rng.integers(0, s)) for s in sizes]
        nb = TXtc._sizeofints(sizes)
        assert nb == JXtc._sizeofints(sizes)
        bj, bt = JXtc._BitWriter(), TXtc._BitWriter()
        JXtc._encodeints(bj, sizes, vals, nb)
        TXtc._encodeints(bt, sizes, vals, nb)
        bj.put(5, 3)
        bt.put(5, 3)
        assert bj.finish() == bt.finish()


OPEN_EXTS = {".sdf": "write_sdf", ".mol": "write_sdf", ".mdl": "write_sdf",
             ".mol2": "write_mol2", ".pdb": "write_pdb", ".ent": "write_pdb",
             ".xyz": "write_xyz", ".gro": "write_gro", ".cif": "write_mmcif",
             ".mmcif": "write_mmcif"}


@pytest.mark.parametrize("ext", sorted(OPEN_EXTS))
def test_open_file_dispatch(ext, tmp_path):
    """open_file picks the reader by extension (upper case too) as the
    reference's does."""
    jm, _ = _mols(seed=7, n_rep=1)
    w = OPEN_EXTS[ext]
    p = tmp_path / f"m{ext.upper()}"
    if w == "write_gro":
        J.write_gro(p, jm, box_extent=np.array([9.0, 9.0, 9.0]))
    elif w == "write_mmcif":
        JMmcif.write_mmcif(jm, p)
    else:
        getattr(J, w)(jm, p)
    same(T.open_file(p), J.open_file(p), ext)


def test_open_file_refuses_unknown(tmp_path):
    for name in ("m.unknown", "m.dcd", "m"):
        with pytest.raises(ValueError, match="unrecognized"):
            T.open_file(tmp_path / name)


def test_read_prmtop_fields(tmp_path):
    """Every MolSpec field of the hand-built prmtop equals the reference's,
    with and without coordinates."""
    p = tmp_path / "t.prmtop"
    p.write_text(_fixture_text())
    rng = np.random.default_rng(8)
    x = rng.normal(0.0, 1.5, (4, 3))
    for coords in (None, x):
        j = JPrm.read_prmtop(str(p), coords=coords)
        t = T.read_prmtop(str(p), coords=coords)
        same(t, j, "MolSpec")
    assert t.n_atoms == 4 and len(t.pairs14) == 1


@pytest.mark.parametrize("rest", ["none", "box", "velocities",
                                  "velocities_box"])
def test_read_inpcrd(rest, tmp_path):
    """Coordinates alone, with a box, with velocities (no box) and with
    velocities and a box, in the 6F12.7 layout."""
    rng = np.random.default_rng(9)
    n = 5
    vals = list(rng.uniform(-9.0, 9.0, 3 * n))
    if "velocities" in rest:
        vals += list(rng.normal(0.0, 1.0, 3 * n))
    if rest.endswith("box"):
        vals += [31.0, 32.0, 33.0, 90.0, 90.0, 90.0]
    rows = ["".join(f"{v:12.7f}" for v in vals[i:i + 6])
            for i in range(0, len(vals), 6)]
    p = tmp_path / "t.inpcrd"
    p.write_text("seeded\n" + f"{n:6d}\n" + "\n".join(rows) + "\n")
    same(T.read_inpcrd(str(p)), JPrm.read_inpcrd(str(p)), rest)
    _, box = T.read_inpcrd(str(p))
    assert (box is not None) == rest.endswith("box")
