#!/usr/bin/env python3
"""Make the bitmap font the port's renderer draws titles with.

    python3 scripts/make_render_font.py

molchanica_tpu's Scene.render writes its title with matplotlib
(DejaVu Sans, 9 pt at 110 dpi, color #444444, at axes (0.02, 0.98),
va="top"). This script renders each printable ASCII character alone
through that same figure layout (900 x 700 pixels, the axes made square
by aspect "equal") in black on white, and keeps its coverage bitmap and
its offset from the text's anchor pixel. For strings it keeps, for every
ordered pair of characters, the pen advance FreeType gives from the first
to the second (advance plus kerning, in 1/64 px), as matplotlib's
FT2Font.set_text lays a string out. Writes
molchanica_tpu_torch/data/render_font.npz (no pickles). matplotlib is
needed only here.
"""
import io
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib import font_manager, ft2font  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "molchanica_tpu_torch", "data", "render_font.npz")
W, H, DPI, SIZE_PT = 900, 700, 110, 9
CHARS = [chr(c) for c in range(32, 127)]


def render_alone(ch):
    """The figure of Scene.render with `ch` as its only content, as
    coverage in [0, 1] (black text on white)."""
    fig = plt.figure(figsize=(W / DPI, H / DPI), dpi=DPI)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_aspect("equal")
    ax.axis("off")
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.text(0.02, 0.98, ch, transform=ax.transAxes, va="top",
            fontsize=SIZE_PT, color="#000000")
    buf = io.BytesIO()
    fig.savefig(buf, dpi=DPI, format="rgba")
    plt.close(fig)
    img = np.frombuffer(buf.getvalue(), np.uint8).reshape(H, W, 4)
    return 255 - img[:, :, 0].astype(np.int32)


def main():
    side = min(W, H)
    ax_x, ax_top = (W - side) / 2 + 0.02 * side, H - 0.98 * side
    glyphs = []
    for ch in CHARS:
        cov = render_alone(ch)
        rows, cols = np.nonzero(cov)
        if len(rows) == 0:
            glyphs.append((0, 0, np.zeros((0, 0), np.uint8)))
            continue
        r0, r1, c0, c1 = rows.min(), rows.max(), cols.min(), cols.max()
        glyphs.append((int(r0 - ax_top), int(c0 - ax_x),
                       cov[r0:r1 + 1, c0:c1 + 1].astype(np.uint8)))
    hmax = max(g[2].shape[0] for g in glyphs)
    wmax = max(g[2].shape[1] for g in glyphs)
    bitmaps = np.zeros((len(CHARS), hmax, wmax), np.uint8)
    for k, (_, _, b) in enumerate(glyphs):
        bitmaps[k, :b.shape[0], :b.shape[1]] = b
    font = ft2font.FT2Font(font_manager.findfont("DejaVu Sans"),
                           hinting_factor=8)
    font.set_size(SIZE_PT, DPI)
    pair = np.zeros((len(CHARS), len(CHARS)), np.int32)
    for i, a in enumerate(CHARS):
        for j, b in enumerate(CHARS):
            pair[i, j] = int(round(font.set_text(a + b)[1, 0]))
    np.savez_compressed(
        OUT, first=np.int32(ord(CHARS[0])),
        row=np.asarray([g[0] for g in glyphs], np.int32),
        col=np.asarray([g[1] for g in glyphs], np.int32),
        height=np.asarray([g[2].shape[0] for g in glyphs], np.int32),
        width=np.asarray([g[2].shape[1] for g in glyphs], np.int32),
        bitmaps=bitmaps, pair_advance_64=pair, dpi=np.int32(DPI),
        size_pt=np.int32(SIZE_PT))
    print(f"{OUT}: {len(CHARS)} glyphs, cells {hmax} x {wmax}")


if __name__ == "__main__":
    main()
