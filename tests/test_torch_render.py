"""Port parity: the headless renderer (molchanica_tpu_torch.render) against
molchanica_tpu.render on the CPU.

- Camera (view_points, scale_at, orbit, zoom, snap_to) and _catmull_rom
  equal to the JAX functions to 1e-12.
- The primitives in draw order, with their fogged colors, widths and
  alpha, equal to what the JAX Scene hands to matplotlib (recorded at
  Axes.add_patch and Axes.add_collection) to 1e-9, for every mode, chain
  and uniform colors, points, H-bonds and a box.
- The port's PNG against matplotlib's PNG of the same JAX scene, 900 x
  700: a foreground mask (a pixel more than 24/255 from the background
  in a channel) with IoU >= IOU_MIN and a mean absolute channel
  difference <= MEAN_MAX (in 0-255 units). The port measures IoU
  0.9828-0.9993 and mean 0.008-0.064 on these scenes (the lowest IoU on
  the backbone trace); with the port's camera turned 15 degrees the same
  scenes measure IoU 0.077-0.906 and mean 1.47-15.3, and both limits
  reject each of them.
- A PNG round trip through zlib.
"""
import functools
import os
import struct
import zlib

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from molchanica_tpu import render as JR  # noqa: E402
from molchanica_tpu.md.snapshot import Snapshot as JSnap  # noqa: E402
from molchanica_tpu.molecules.common import \
    MoleculeCommon as JMol  # noqa: E402
from molchanica_tpu_torch import render as TR  # noqa: E402
from molchanica_tpu_torch.md.snapshot import Snapshot as TSnap  # noqa: E402
from molchanica_tpu_torch.molecules.common import \
    MoleculeCommon as TMol  # noqa: E402

torch.set_num_threads(1)
IOU_MIN, MEAN_MAX, FG = 0.95, 0.25, 24
PEP = "AAGASGLKW"


def _mols(smiles="CC(=O)Oc1ccccc1C(=O)O"):
    from molchanica_tpu.molecules.embed import embed_3d as je
    from molchanica_tpu.molecules.smiles import from_smiles as jf
    from molchanica_tpu_torch.molecules.embed import embed_3d as te
    from molchanica_tpu_torch.molecules.smiles import from_smiles as tf
    jm, tm = jf(smiles), tf(smiles)
    je(jm)
    te(tm)
    np.testing.assert_array_equal(np.asarray(jm.positions), tm.positions)
    jm.name = tm.name = "aspirin"
    return jm, tm


def _peptides():
    from molchanica_tpu.molecules.peptide_builder import build_peptide as jb
    from molchanica_tpu_torch.molecules.peptide_builder import \
        build_peptide as tb
    return jb(PEP), tb(PEP)


def _chain_mols():
    kw = dict(elements=["N", "C", "C", "O"],
              positions=np.array([[0.0, 0, 0], [1.4, 0, 0], [2.8, 0.4, 0],
                                  [3.9, -0.3, 0.2]]),
              bonds=[(0, 1), (1, 2), (2, 3)], chains=["A", "A", "B", "B"])
    return JMol(**kw), TMol(**kw)


def _snap_kw(seed=1):
    rs = np.random.RandomState(seed)
    return dict(time=1.25, atom_posits=rs.normal(size=(5, 3)) * 2.0 + 10.0,
                water_o_posits=rs.uniform(0, 20, size=(30, 3)),
                water_h0_posits=rs.uniform(0, 20, size=(30, 3)),
                water_h1_posits=rs.uniform(0, 20, size=(30, 3)),
                box_extent=np.array([20.0, 20.0, 20.0]))


SNAP_ELS = ["C", "C", "O", "N", "H"]
SNAP_BONDS = [(0, 1), (1, 2), (1, 3)]


@functools.lru_cache(maxsize=2)
def _scenes(turn=0.0):
    """(name, JAX scene, port scene, title) for every case, built once
    per camera turn (no test changes a scene)."""
    out = []
    jm, tm = _mols()
    for mode in ("ball_stick", "sticks", "spheres", "points"):
        for hyd in (True, False):
            js, ts = JR.Scene(), TR.Scene(device="cpu")
            js.add_mol(jm, JR.RenderStyle(mode=mode, show_hydrogens=hyd))
            ts.add_mol(tm, TR.RenderStyle(mode=mode, show_hydrogens=hyd))
            out.append((f"{mode}-h{int(hyd)}", js, ts, "aspirin"))
    jp, tp = _peptides()
    for color_by in ("chain", "uniform"):
        js, ts = JR.Scene(), TR.Scene(device="cpu")
        js.add_mol(jp, JR.RenderStyle(mode="backbone", color_by=color_by))
        ts.add_mol(tp, TR.RenderStyle(mode="backbone", color_by=color_by))
        out.append((f"backbone-{color_by}", js, ts, PEP))
    jc, tc = _chain_mols()
    for color_by in ("chain", "uniform"):
        js, ts = JR.Scene(), TR.Scene(device="cpu")
        js.add_mol(jc, JR.RenderStyle(color_by=color_by))
        ts.add_mol(tc, TR.RenderStyle(color_by=color_by))
        js.add_hbonds([(jc.positions[0], jc.positions[3])])
        ts.add_hbonds([(tc.positions[0], tc.positions[3])])
        out.append((f"hbonds-{color_by}", js, ts, ""))
    kw = _snap_kw()
    js = _jax_snapshot_scene(JSnap(**kw))
    ts = TR.snapshot_scene(TSnap(**kw), SNAP_ELS, SNAP_BONDS, device="cpu")
    out.append(("snapshot", js, ts, "t = 1.25 ps"))
    for _, js, ts, _ in out:
        js._frame_if_needed()
        ts._frame_if_needed()
        ts.camera.orbit(d_azimuth_deg=turn)
    return out


def _jax_snapshot_scene(snap):
    """The Scene that the JAX render_snapshot builds (recorded by
    standing in for Scene.render)."""
    seen = {}

    def keep(self, path, size=(900, 700), dpi=110, title=""):
        seen["scene"] = self
        return path

    orig = JR.Scene.render
    JR.Scene.render = keep
    try:
        JR.render_snapshot(snap, SNAP_ELS, "unused.png", bonds=SNAP_BONDS)
    finally:
        JR.Scene.render = orig
    return seen["scene"]


def _record(scene, monkeypatch, path="unused.png"):
    """What the JAX Scene.render hands to matplotlib: circles in order,
    then each LineCollection's segments, colors, widths and style."""
    from matplotlib.axes import Axes
    rec = {"discs": [], "lines": []}
    orig_patch, orig_coll = Axes.add_patch, Axes.add_collection

    def add_patch(self, p, *a, **k):
        rec["discs"].append((np.asarray(p.center, float), p.radius,
                             np.asarray(p.get_facecolor(), float),
                             p.get_zorder()))
        return orig_patch(self, p, *a, **k)

    def add_collection(self, c, *a, **k):
        rec["lines"].append(dict(
            segs=np.asarray(c.get_segments(), float),
            rgba=np.asarray(c.get_colors(), float),
            widths=np.asarray(c.get_linewidths(), float),
            dashed=c.get_linestyle()[0][1] is not None,
            zorder=c.get_zorder()))
        return orig_coll(self, c, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(Axes, "add_patch", add_patch)
        m.setattr(Axes, "add_collection", add_collection)
        if path == "unused.png":
            m.setattr(matplotlib.figure.Figure, "savefig",
                      lambda self, *a, **k: None)
        scene.render(path)
    return rec


def _decode_png(path):
    """An 8-bit RGB PNG of filter-0 rows, through zlib and struct."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 2)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def _image_metrics(ref, got, bg=255):
    ref, got = ref.astype(np.int32), got.astype(np.int32)
    fa = np.abs(ref - bg).max(-1) > FG
    fb = np.abs(got - bg).max(-1) > FG
    return (fa & fb).sum() / max((fa | fb).sum(), 1), np.abs(ref - got).mean()


def test_camera_equal():
    rs = np.random.RandomState(0)
    pts = rs.normal(size=(50, 3)) * 8.0 + 100.0
    jc, tc = JR.Camera(), TR.Camera()
    for c in (jc, tc):
        c.snap_to(pts)
        c.orbit(d_azimuth_deg=33.0, d_elevation_deg=-21.0)
        c.zoom(1.7)
        c.orbit(d_elevation_deg=200.0)
    for f in ("distance", "azimuth_deg", "elevation_deg"):
        assert getattr(tc, f) == getattr(jc, f)
    np.testing.assert_allclose(tc.target, jc.target, rtol=0, atol=1e-12)
    for c in (jc, tc):
        c.orbit(d_elevation_deg=-150.0)
    q = rs.normal(size=(40, 3)) * 12.0 + 95.0
    (xj, dj), (xt, dt) = jc.view_points(q), tc.view_points(q)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tc.scale_at(q), jc.scale_at(q), rtol=0,
                               atol=1e-12)


def test_catmull_rom_equal():
    pts = np.random.RandomState(2).normal(size=(7, 3))
    for per in (1, 4, 8):
        np.testing.assert_allclose(TR._catmull_rom(pts, per),
                                   JR._catmull_rom(pts, per), rtol=0,
                                   atol=1e-12)
    np.testing.assert_array_equal(TR._catmull_rom(pts[:2]), pts[:2])


N_SCENES = 13


def test_scene_count():
    assert len(_scenes()) == N_SCENES


@pytest.mark.parametrize("case", range(N_SCENES))
def test_primitives_match_reference(case, monkeypatch):
    name, js, ts, _ = _scenes()[case]
    rec = _record(js, monkeypatch)
    p = ts.primitives()
    disc = p.kind == TR.DISC
    assert len(rec["discs"]) == int(disc.sum()), name
    if len(rec["discs"]):
        np.testing.assert_allclose(p.a[disc], [d[0] for d in rec["discs"]],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(p.size[disc], [d[1] for d in rec["discs"]],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(
            np.concatenate([p.rgb[disc], p.alpha[disc, None]], 1),
            [d[2] for d in rec["discs"]], rtol=0, atol=1e-9)
        assert {d[3] for d in rec["discs"]} == {3}
    seg, dash = p.kind != TR.DISC, p.kind == TR.DASH
    lines = rec["lines"]
    assert len(lines) == int(seg.any()) + int(dash.any()), name
    for sel, lc, dashed, z in ((seg, lines[:1], False, 2),
                               (dash, lines[1:], True, 4)):
        if not sel.any():
            continue
        lc = lc[0]
        assert lc["dashed"] == dashed and lc["zorder"] == z
        np.testing.assert_allclose(lc["segs"][:, 0], p.a[sel], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(lc["segs"][:, 1], p.b[sel], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(
            lc["rgba"], np.concatenate([p.rgb[sel], p.alpha[sel, None]], 1),
            rtol=0, atol=1e-9)
        np.testing.assert_allclose(lc["widths"], p.size[sel], rtol=0,
                                   atol=1e-9)
    # far first; equal depths keep generation order
    assert (np.diff(p.depth) <= 0).all()


def test_view_fit_matches_axes_limits(monkeypatch):
    from matplotlib.axes import Axes
    for name, js, ts, _ in _scenes():
        lims = []
        with monkeypatch.context() as m:
            m.setattr(Axes, "set_xlim",
                      lambda self, a, b, *r, **k: lims.append((a, b)))
            m.setattr(Axes, "set_ylim",
                      lambda self, a, b, *r, **k: lims.append((a, b)))
            m.setattr(matplotlib.figure.Figure, "savefig",
                      lambda self, *a, **k: None)
            js.render("unused.png")
        c, half = TR.view_fit(ts.primitives())
        np.testing.assert_allclose(
            lims, [(c[0] - half, c[0] + half), (c[1] - half, c[1] + half)],
            rtol=0, atol=1e-9, err_msg=name)


_REF_IMAGES = {}


def _pngs(tmp_path, turn=0.0):
    """(name, matplotlib's image of the JAX scene, the port's image) per
    scene; the JAX scenes are never turned, so their images are drawn
    once."""
    out = []
    for name, js, ts, title in _scenes(turn):
        if name.endswith("-h0") or name.endswith("uniform"):
            continue
        if name not in _REF_IMAGES:
            pj = str(tmp_path / f"{name}-j.png")
            js.render(pj, title=title)
            _REF_IMAGES[name] = (plt.imread(pj)[:, :, :3] * 255.0
                                 + 0.5).astype(np.uint8)
        pt = str(tmp_path / f"{name}-t.png")
        ts.render(pt, title=title)
        out.append((name, _REF_IMAGES[name], _decode_png(pt)))
    return out


def test_png_matches_matplotlib(tmp_path):
    for name, ref, got in _pngs(tmp_path):
        assert got.shape == ref.shape == (700, 900, 3), name
        iou, mean = _image_metrics(ref, got)
        assert iou >= IOU_MIN and mean <= MEAN_MAX, (name, iou, mean)


def test_turned_camera_fails_the_image_limits(tmp_path):
    for name, ref, got in _pngs(tmp_path, turn=15.0):
        iou, mean = _image_metrics(ref, got)
        assert iou < IOU_MIN and mean > MEAN_MAX, (name, iou, mean)


def test_png_roundtrip_and_extension(tmp_path):
    img = np.random.RandomState(3).randint(0, 256, (37, 53, 3)).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    assert TR.write_png(path, img) == path
    np.testing.assert_array_equal(_decode_png(path), img)
    jm, tm = _mols()
    with pytest.raises(ValueError, match="PNG"):
        TR.render_molecule(tm, str(tmp_path / "x.svg"), device="cpu")
    out = TR.render_molecule(tm, str(tmp_path / "m.png"), device="cpu")
    assert os.path.getsize(out) > 5000
    assert _decode_png(out).shape == (700, 900, 3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_card_default_raises_without_cuda(tmp_path):
    """The rasterizer and the scene default to the card and never fall
    back to the CPU on their own."""
    jm, tm = _mols()
    sc = TR.Scene()
    sc.add_mol(tm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.rasterize(sc.primitives())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.render(str(tmp_path / "m.png"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.render_molecule(tm, str(tmp_path / "m.png"))


def test_render_snapshot_writes_the_frame(tmp_path):
    out = TR.render_snapshot(TSnap(**_snap_kw()), SNAP_ELS,
                             str(tmp_path / "frame.png"), bonds=SNAP_BONDS,
                             device="cpu")
    assert os.path.getsize(out) > 5000


def test_cli_camera_and_render_verbs(tmp_path):
    from molchanica_tpu import cli as J
    from molchanica_tpu_torch import cli as T
    js, ts = J.CliState(), T.CliState(device="cpu")
    for cmd in ("load smiles:CCO", "move 1 2 3", "rotate z 90", "orient",
                "turn x 45", "turn y -30", "turn z 10", "zoom 1.5"):
        assert J.handle_cmd(js, cmd) == T.handle_cmd(ts, cmd), cmd
    np.testing.assert_array_equal(np.asarray(js.active_mol().positions),
                                  ts.active_mol().positions)
    pj, pt = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    a, b = J.handle_cmd(js, f"png {pj}"), T.handle_cmd(ts, f"png {pt}")
    assert b == a.replace(pj, pt) and os.path.getsize(pt) > 2000
    ref = (plt.imread(pj)[:, :, :3] * 255.0 + 0.5).astype(np.uint8)
    iou, mean = _image_metrics(ref, _decode_png(pt))
    assert iou >= IOU_MIN and mean <= MEAN_MAX, (iou, mean)
