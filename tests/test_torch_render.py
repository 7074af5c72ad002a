"""The port's cv2-free renderer (``adas_tpu_torch/render``,
``adas_tpu_torch/native/draw.cpp``) against cv2, on the CPU.

Identical to the pixel (tolerance 0): filled and outlined rectangles,
1-px lines, ``fill_poly`` on the lane-area and icon polygons,
``add_weighted``, ``copy_make_border``, ``resize_linear``, the nine panel
icons against the JAX package's, and the Y4M planes against
``cv2.cvtColor``.  Thick lines, arrowed lines and circles: the set of
written pixels differs from cv2's on at most 1% of its pixels, each
differing pixel within one pixel of cv2's mask edge (the share is
printed; on these seeds it is 0).  One gap is known and not exercised
by the HUD: ``fill_poly`` with vertices far outside the canvas differs
from cv2's on a few edge pixels of about 1% of random polygons.

Text.  The cv2 of this environment (5.x) draws its ``FONT_HERSHEY_*``
faces as TrueType glyphs of three weights, not as Hershey strokes: a
string is the union of per-glyph bitmaps at integer pen positions, the
pixel size is ``round(fontScale * 1000 / 37)`` and the advances are
integers per size.  The committed glyph table
(``adas_tpu_torch/render/glyphs.npz``) holds, per weight, the advances
and descents for sizes 1-160 px and the glyph coverage bitmaps (``LINE_8``
and ``LINE_AA``) at the sizes the HUD draws; :func:`recover_glyph_table`
below recovers it from cv2 renders and is run by hand (see its
docstring).  The tests re-render every glyph of the table against cv2
(identical), hold ``get_text_size`` to ``cv2.getTextSize`` and each HUD
string's ink to cv2's.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLYPH_TABLE = os.path.join(REPO, "adas_tpu_torch", "render", "glyphs.npz")

#: (cv2 font, thickness) that selects each of cv2's three glyph weights
WEIGHT_PROBES = ((0, 1), (0, 2), (3, 2))
#: pixel sizes whose glyph bitmaps the table holds: every size of the
#: HUD's scaled labels (fontScale <= 1), and the curve text (3) and the
#: warning icon's '!' (200 / 70)
ATLAS_PX = tuple(range(1, 28)) + (77, 81)
#: the largest pixel size of the advance table
MAX_PX = 160
CHARS = [chr(c) for c in range(32, 127)]


def recover_glyph_table(path: str = GLYPH_TABLE) -> None:
    """Recover the glyph table from cv2 renders and write it to ``path``.

    Run by hand from the repository root when the table must be made
    again (it needs cv2):

        python -c "import sys; sys.path.insert(0, 'tests'); \\
            import test_torch_render as t; t.recover_glyph_table()"

    Per weight (the ``WEIGHT_PROBES`` font and thickness) and pixel size
    ``px`` (drawn at ``fontScale = px * 37 / 1000``): each character's
    advance (``getTextSize`` of the character before '|' less that of
    '|') and descent (``getTextSize``'s baseline); and at the
    ``ATLAS_PX`` sizes the character drawn alone in white on black with
    ``LINE_8`` and with ``LINE_AA`` (cv2 5 blends both: the value is the
    glyph's coverage; the two line types cover differently), cropped to
    its ink with the crop's offset from the origin.  Checks
    that each size's glyphs are ``px`` high and that the re-rendered
    table equals cv2's glyphs."""
    n_w, n_c = len(WEIGHT_PROBES), len(CHARS)
    adv = np.zeros((n_w, MAX_PX + 1, n_c), np.uint16)
    desc = np.zeros((n_w, MAX_PX + 1, n_c), np.uint16)
    index = np.zeros((n_w, len(ATLAS_PX), n_c, 2, 5), np.int32)  # offset, h, w, dx, dy
    pix, size = [], 0
    for wi, (font, th) in enumerate(WEIGHT_PROBES):
        for px in range(1, MAX_PX + 1):
            s = px * 37 / 1000
            bar = cv2.getTextSize("|", font, s, th)[0][0]
            for ci, c in enumerate(CHARS):
                (w, h), base = cv2.getTextSize(c, font, s, th)
                assert h == px, (font, th, px, c, h)
                adv[wi, px, ci] = cv2.getTextSize(c + "|", font, s, th)[0][0] - bar
                desc[wi, px, ci] = base
        for ai, px in enumerate(ATLAS_PX):
            s = px * 37 / 1000
            ox, oy = 2 * px + 4, 3 * px + 4
            for ci, c in enumerate(CHARS):
                for li, lt in enumerate((cv2.LINE_8, cv2.LINE_AA)):
                    canvas = np.zeros((5 * px + 8, 5 * px + 8), np.uint8)
                    cv2.putText(canvas, c, (ox, oy), font, s, 255, th, lt)
                    ys, xs = np.nonzero(canvas)
                    if len(ys) == 0:
                        index[wi, ai, ci, li] = (size, 0, 0, 0, 0)
                        continue
                    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
                    crop = canvas[y0:y1, x0:x1]
                    index[wi, ai, ci, li] = (size, y1 - y0, x1 - x0, x0 - ox, y0 - oy)
                    pix.append(crop.reshape(-1))
                    size += crop.size
    np.savez_compressed(path, adv=adv, desc=desc, index=index,
                        atlas_px=np.array(ATLAS_PX, np.int32), alpha=np.concatenate(pix))


from adas_tpu_torch.render import draw as D  # noqa: E402
from adas_tpu_torch.render import text as T  # noqa: E402

SIZES = [(120, 160), (360, 640)]


def _canvases(hw, nch, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (*hw, nch), dtype=np.uint8)
    return base, base.copy(), base.copy()


def _points(rng, hw, n, margin):
    h, w = hw
    return [(int(rng.integers(-margin * w, (1 + margin) * w)),
             int(rng.integers(-margin * h, (1 + margin) * h))) for _ in range(n)]


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("line_type", [4, 8, 16])
def test_rectangles_identical(hw, line_type):
    """Outlined (thickness 1-4) and filled rectangles, corners inside and
    far outside the canvas, on 3 and 4 channels."""
    rng = np.random.default_rng(1)
    for k in range(60):
        nch = 3 + k % 2
        _, want, got = _canvases(hw, nch, k)
        p1, p2 = _points(rng, hw, 2, 0.3)
        color = tuple(int(v) for v in rng.integers(0, 256, nch))
        for th in (-1, 1, 2, 4):
            cv2.rectangle(want, p1, p2, color, th, line_type)
            D.rectangle(got, p1, p2, color, th, line_type)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("line_type", [4, 8, 16])
def test_thin_lines_identical(hw, line_type):
    """1-px lines, clipped at the canvas edges, in every line type."""
    rng = np.random.default_rng(2)
    _, want, got = _canvases(hw, 3, 0)
    for _ in range(300):
        p1, p2 = _points(rng, hw, 2, 0.5)
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        cv2.line(want, p1, p2, color, 1, line_type)
        D.line(got, p1, p2, color, 1, line_type)
    np.testing.assert_array_equal(got, want)


def _lane_area(rng, hw):
    """A lane-area polygon as ``LaneInfo.update_area`` builds it: the left
    ego lane's points bottom-up, then the right's top-down."""
    h, w = hw
    ys = np.sort(rng.integers(int(0.55 * h), h, 12))[::-1]
    left = np.stack([rng.integers(int(0.1 * w), int(0.45 * w), 12), ys], -1)
    right = np.stack([rng.integers(int(0.55 * w), int(0.9 * w), 12), ys], -1)
    return np.concatenate([left, right[::-1]]).astype(np.int32)


@pytest.mark.parametrize("hw", SIZES + [(720, 1280)])
@pytest.mark.parametrize("line_type", [8, 16])
def test_fill_poly_identical(hw, line_type):
    """``fill_poly`` on lane-area polygons (zig-zagging, so concave and
    self-touching), random concave polygons inside the canvas, and the
    panel icons' polygons."""
    rng = np.random.default_rng(3)
    s = 200
    icon_polys = [
        [[s // 2 - s // 12, int(s * 0.85)], [s // 2 + s // 12, int(s * 0.85)],
         [s // 2 + s // 12, int(s * 0.45)], [s // 2 - s // 12, int(s * 0.45)]],
        [[s // 2 - s // 5, int(s * 0.45)], [s // 2 + s // 5, int(s * 0.45)], [s // 2, int(s * 0.18)]],
        [[s // 2, int(s * 0.1)], [int(s * 0.08), int(s * 0.9)], [int(s * 0.92), int(s * 0.9)]],
    ]
    polys = [_lane_area(rng, hw) for _ in range(20)]
    polys += [rng.integers(0, min(hw), (int(rng.integers(3, 9)), 2)) for _ in range(40)]
    polys += [np.array(p) for p in icon_polys]
    for k, poly in enumerate(polys):
        _, want, got = _canvases(hw, 3 + k % 2, k)
        color = tuple(int(v) for v in rng.integers(0, 256, 4))
        cv2.fillPoly(want, [np.asarray(poly, np.int32)], color, line_type)
        D.fill_poly(got, [poly], color, line_type)
        np.testing.assert_array_equal(got, want)


def _edge_share(want_mask, got_mask):
    """(share of cv2's written pixels that differ, whether every differing
    pixel lies within one pixel of cv2's mask edge)."""
    diff = want_mask != got_mask
    pad = np.pad(want_mask, 1, mode="edge")
    h, w = want_mask.shape
    nb = [pad[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w] for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    edge = np.any([n != want_mask for n in nb], axis=0)
    near_edge = np.zeros_like(edge)
    pe = np.pad(edge, 1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            near_edge |= pe[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
    return diff.sum() / max(1, want_mask.sum()), bool(np.all(near_edge[diff]))


@pytest.mark.parametrize("shape", ["line", "arrow", "circle"])
@pytest.mark.parametrize("line_type", [4, 8, 16])
def test_thick_strokes_within_edge_tolerance(shape, line_type):
    """Thick lines and arrowed lines (thickness 2-12) and circles (radius
    0-10, thickness -1 to 12), end points inside and outside the canvas:
    the written pixels differ from cv2's on at most 1% of cv2's, each
    within one pixel of cv2's mask edge.  Measured: no pixel differs on
    these seeds (the test prints the worst share)."""
    rng = np.random.default_rng(4)
    hw = (120, 160)
    shares = []
    for k in range(150):
        want, got = np.zeros(hw, np.uint8), np.zeros(hw, np.uint8)
        p1, p2 = _points(rng, hw, 2, 0.3)
        if shape == "circle":
            r, th = int(rng.integers(0, 11)), int(rng.choice([-1, 1, 2, 3, 5, 8, 12]))
            cv2.circle(want, p1, r, 255, th, line_type)
            D.circle(got, p1, r, 255, th, line_type)
        else:
            th = int(rng.integers(2, 13))
            if shape == "line":
                cv2.line(want, p1, p2, 255, th, line_type)
                D.line(got, p1, p2, 255, th, line_type)
            else:
                tip = float(rng.uniform(0.1, 0.5))
                cv2.arrowedLine(want, p1, p2, 255, th, line_type, 0, tip)
                D.arrowed_line(got, p1, p2, 255, th, line_type, 0, tip)
        share, near = _edge_share(want > 0, got > 0)
        assert near, (shape, line_type, k)
        shares.append(share)
    print(f"{shape} line_type {line_type}: worst share {max(shares):.4f}, mean {np.mean(shares):.5f}")
    assert max(shares) <= 0.01


@pytest.mark.parametrize("alpha, gamma", [(0.3, 0), (0.85, 0), (0.6, 1.0), (0.6, 0)])
def test_add_weighted_identical(alpha, gamma):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)
    for x, y in ((a, b), (b, a)):
        np.testing.assert_array_equal(D.add_weighted(x, alpha, y, 1 - alpha, gamma),
                                      cv2.addWeighted(x, alpha, y, 1 - alpha, gamma))


def test_copy_make_border_identical():
    img = np.random.default_rng(6).integers(0, 256, (90, 160, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        D.copy_make_border(img, 10, 10, 10, 10, 0),
        cv2.copyMakeBorder(img, 10, 10, 10, 10, cv2.BORDER_CONSTANT, value=[0, 0, 0]))


@pytest.mark.parametrize("src_hw, dst_wh", [
    ((720, 1280), (320, 180)), ((360, 640), (160, 90)),  # the bird-view inset (0.25)
    ((720, 1280), (640, 360)), ((360, 640), (320, 180)), ((1080, 1920), (1280, 720)),
    ((361, 643), (157, 93)),  # host_downscale ratios, and odd ones
])
def test_resize_linear_identical(src_hw, dst_wh):
    img = np.random.default_rng(7).integers(0, 256, (*src_hw, 3), dtype=np.uint8)
    np.testing.assert_array_equal(D.resize_linear(img, dst_wh),
                                  cv2.resize(img, dst_wh, interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("name, args", [
    ("_arrow_icon", (200, "up")), ("_arrow_icon", (200, "left")), ("_arrow_icon", (200, "right")),
    ("_warn_icon", (200,)), ("_collision_icon", (100, (0, 0, 255))),
    ("_collision_icon", (100, (0, 102, 255))), ("_collision_icon", (100, (0, 255, 0))),
    ("_lane_departure_icon", (300, 200, "left")), ("_lane_departure_icon", (300, 200, "right")),
])
def test_panel_icons_identical_to_jax(name, args):
    """The nine procedural icons against the JAX package's (cv2-drawn):
    the turn arrows are its ``getRotationMatrix2D`` + ``warpAffine``
    rotation, not ``np.rot90``."""
    from adas_tpu.pipeline import panel as jax_panel
    from adas_tpu_torch.pipeline import panel

    np.testing.assert_array_equal(getattr(panel, name)(*args), getattr(jax_panel, name)(*args))


def test_rotate_icon_is_not_rot90():
    icon = np.random.default_rng(8).integers(0, 256, (200, 200, 4), dtype=np.uint8)
    got = D.rotate_icon(icon, 90)
    m = cv2.getRotationMatrix2D((100.0, 100.0), 90, 1.0)
    np.testing.assert_array_equal(got, cv2.warpAffine(icon, m, (200, 200)))
    assert not np.array_equal(got, np.rot90(icon))


@pytest.mark.parametrize("font", [0, 3, 4])
def test_get_text_size_equals_cv2(font):
    """Every printable character alone, all of printable ASCII as one
    string and seeded random strings, at scales 0.4-3 and thicknesses
    1-5."""
    rng = np.random.default_rng(9)
    strings = CHARS + ["".join(CHARS)] + [
        "".join(rng.choice(CHARS, int(rng.integers(2, 24)))) for _ in range(20)]
    for scale in np.linspace(0.4, 3.0, 14):
        for th in range(1, 6):
            for s in strings:
                assert T.get_text_size(s, font, scale, th) == cv2.getTextSize(s, font, scale, th), \
                    (s, font, scale, th)


@pytest.mark.parametrize("weight", range(len(WEIGHT_PROBES)))
def test_glyph_table_rerenders_cv2(weight):
    """Every glyph of the committed table at every table size, both line
    types, drawn alone by ``put_text``, equals cv2's glyph to the pixel
    (on a grey canvas, in a colour, so the blend is checked too)."""
    font, th = WEIGHT_PROBES[weight]
    for px in ATLAS_PX:
        s = px * 37 / 1000
        for lt in (cv2.LINE_8, cv2.LINE_AA):
            want = np.full((3 * px + 8, len(CHARS) * (2 * px + 4), 3), 90, np.uint8)
            got = want.copy()
            for i, c in enumerate(CHARS):
                org = (i * (2 * px + 4) + px // 2, 2 * px + 4)
                cv2.putText(want, c, org, font, s, (20, 240, 160), th, lt)
                T.put_text(got, c, org, font, s, (20, 240, 160), th, lt)
            np.testing.assert_array_equal(got, want, err_msg=f"{px} px, line type {lt}")


#: every (string, font, scale, thickness, line type) the HUD draws, with
#: the HUD's dynamic parts at representative values
HUD_TEXT = [
    ("LDWS : Please Keep Right", 0, 0.7, 2, 8), ("LKAS : Hard Left Curve Ahead", 0, 0.7, 2, 8),
    ("FPS  : 29.97", 0, 0.6, 2, 16), ("FCWS : Warning", 0, 0.6, 2, 8),
    ("object-infer : 0.02 s", 0, 0.5, 1, 16), ("lane-infer : 0.02 s", 0, 0.5, 1, 16),
    ("Offset: -0.3 m", 0, 3, 5, 8), ("R : 1234.5 m", 0, 3, 5, 8), ("R : nan m", 0, 3, 5, 8),
    ("person", 4, 0.75, 2, 8), ("traffic light", 4, 0.75, 2, 8), ("!", 4, 200 / 70, 5, 8),
    (" 12.34 m", 4, 0.4, 1, 8), (" 12.34 m", 3, 0.4, 2, 8), (" 1.52 m", 4, 1 / 1.52, 1, 8),
    (" 1.52 m", 3, 1 / 1.52, 2, 8), (" unknown m", 4, 0.4, 1, 8),
    ("ID: 17", 4, 0.05, 1, 8), ("ID: 17", 3, 0.05, 2, 8), ("ID: 3", 4, 0.53, 1, 8),
    ("ID: 3", 3, 0.53, 2, 8), ("car : 4", 4, 0.96, 2, 8),
]


@pytest.mark.parametrize("text, font, scale, th, lt", HUD_TEXT)
def test_hud_text_identical(text, font, scale, th, lt):
    """Each HUD string at its font, scale, thickness and line type: the ink
    mask's IoU with cv2's is at least 0.9, and the pixels are in fact
    identical (the table holds every size the HUD draws)."""
    rng = np.random.default_rng(10)
    base = rng.integers(0, 256, (300, 1400, 3), dtype=np.uint8)
    want, got = base.copy(), base.copy()
    cv2.putText(want, text, (30, 220), font, scale, (0, 255, 255), th, lt)
    T.put_text(got, text, (30, 220), font, scale, (0, 255, 255), th, lt)
    ink_w, ink_g = np.any(want != base, -1), np.any(got != base, -1)
    assert (ink_w & ink_g).sum() / max(1, (ink_w | ink_g).sum()) >= 0.9
    np.testing.assert_array_equal(got, want)


def test_text_off_canvas_and_non_ascii():
    """Glyphs partly or wholly off the canvas are clipped; a non-ASCII
    character draws as '?', as cv2 draws it."""
    for org in ((-20, 10), (600, 700), (630, 30), (-500, -500)):
        want = np.zeros((360, 640, 3), np.uint8)
        got = want.copy()
        cv2.putText(want, "Offset: 1.0 m", org, 0, 0.7, (255, 0, 0), 2)
        T.put_text(got, "Offset: 1.0 m", org, 0, 0.7, (255, 0, 0), 2)
        np.testing.assert_array_equal(got, want)
    want = np.zeros((60, 200), np.uint8)
    got = want.copy()
    cv2.putText(want, "a?b", (5, 40), 0, 1, 255, 1)
    T.put_text(got, "aéb", (5, 40), 0, 1, 255, 1)
    np.testing.assert_array_equal(got, want)


def test_native_draw_rejects_what_it_cannot_draw():
    with pytest.raises(ValueError, match="writable"):
        D.line(np.zeros((10, 10, 3), np.uint8)[:, ::2], (0, 0), (5, 5), (255, 0, 0))
    with pytest.raises(ValueError, match="uint8"):
        D.circle(np.zeros((10, 10, 3), np.float32), (5, 5), 2, (1, 0, 0))
    with pytest.raises(ValueError, match="positive"):
        D.line(np.zeros((10, 10, 3), np.uint8), (0, 0), (5, 5), (255, 0, 0), 0)


@pytest.mark.parametrize("hw", [(360, 640), (720, 1280)])
def test_control_panel_matches_jax(hw, monkeypatch):
    """``ControlPanel`` against the JAX package's over a sequence of
    signals that walks the curve-status hysteresis and every collision
    type, on a frame smaller than the fixed 400x365 signs widget and on
    720p; the FPS readout is on a fixed clock."""
    import itertools

    import adas_tpu.pipeline.panel as jax_panel_mod
    import adas_tpu_torch.pipeline.panel as panel_mod
    from adas_tpu.utils import types as jt
    from adas_tpu_torch.utils import types as pt

    def clock():
        class Clock:  # one per module: both panels read the same times
            t = 1000.0

            @classmethod
            def time(cls):
                cls.t += 0.04
                return cls.t

        return Clock

    monkeypatch.setattr(jax_panel_mod, "time", clock())
    monkeypatch.setattr(panel_mod, "time", clock())
    jax_panel, panel = jax_panel_mod.ControlPanel(), panel_mod.ControlPanel()
    rng = np.random.default_rng(11)
    curves = ["UNKNOWN", "HARD_LEFT", "EASY_LEFT", "STRAIGHT", "HARD_RIGHT", "EASY_RIGHT"]
    offsets = ["UNKNOWN", "CENTER", "RIGHT", "LEFT"]
    collisions = ["UNKNOWN", "NORMAL", "PROMPT", "WARNING"]
    steps = list(itertools.product(curves, offsets))
    for i, (curve, offset) in enumerate(steps * 2):
        frame = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        bird = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        collision = collisions[i % 4]
        out = []
        for p, t in ((jax_panel, jt), (panel, pt)):
            f = frame.copy()
            p.DisplayBirdViewPanel(f, bird)
            p.DisplaySignsPanel(f, getattr(t.OffsetType, offset), getattr(t.CurvatureType, curve))
            p.DisplayCollisionPanel(f, getattr(t.CollisionType, collision), 0.02 * i, 0.013)
            out.append(f)
        np.testing.assert_array_equal(out[1], out[0], err_msg=f"{curve} {offset} {collision}")
        assert panel.curve_status == jax_panel.curve_status
    assert panel.fps == jax_panel.fps > 0


def test_facade_drawing_matches_jax():
    """The detector's boxes and labels (keypoints, the label box sized with
    font 0 and filled with ``LINE_AA``, the corner box, the TRIPLEX label),
    the lane facade's points and area, and the distance labels, each
    against the JAX method on the same state."""
    from adas_tpu.analytics.distance import SingleCamDistanceMeasure as JaxDistance
    from adas_tpu.perception.lane_detector import LaneDetectBase as JaxLaneBase
    from adas_tpu.perception.object_detector import ObjectDetectBase as JaxObjectBase
    from adas_tpu.utils.types import OffsetType as JaxOffset
    from adas_tpu.utils.types import RectInfo as JaxRect
    from adas_tpu_torch.analytics.distance import SingleCamDistanceMeasure
    from adas_tpu_torch.perception.lane_detector import LaneDetectBase
    from adas_tpu_torch.perception.object_detector import ObjectDetectBase
    from adas_tpu_torch.utils.types import OffsetType, RectInfo

    rng = np.random.default_rng(12)
    labels = ["car", "person", "traffic light", "truck", "bus"]
    rows = [(float(rng.uniform(-40, 600)), float(rng.uniform(-20, 320)), float(rng.uniform(8, 200)),
             float(rng.uniform(8, 160)), labels[k % 5]) for k in range(40)]
    colors = {lab: tuple(int(v) for v in rng.integers(0, 256, 3)) for lab in labels}
    frame = rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)
    lanes = np.array([[(int(x), int(y)) for x, y in zip(rng.integers(0, 640, 18), np.linspace(200, 359, 18))]
                      for _ in range(4)], dtype=object)
    area = np.array([[150, 359], [260, 210], [380, 210], [520, 359]])
    outs = []
    for obj_cls, rect, lane_cls, dist_cls, offset in (
            (JaxObjectBase, JaxRect, JaxLaneBase, JaxDistance, JaxOffset.RIGHT),
            (ObjectDetectBase, RectInfo, LaneDetectBase, SingleCamDistanceMeasure, OffsetType.RIGHT)):
        det = object.__new__(obj_cls)
        det.colors_dict = colors
        objs = [rect(x, y, w, h, conf=0.9, label=lab, kpss=[(int(x) + 3, int(y) + 4)])
                for x, y, w, h, lab in rows]
        det._object_info = objs
        lane = lane_cls()
        lane.lane_info.lanes_points = lanes
        lane.lane_info._area_status = True
        lane.lane_info._area_points = area
        dist = dist_cls()
        dist.updateDistance(objs)
        f = frame.copy()
        lane.DrawDetectedOnFrame(f, offset)
        lane.DrawAreaOnFrame(f, (255, 191, 0))
        det.DrawDetectedOnFrame(f)
        dist.DrawDetectedOnFrame(f)
        outs.append(f)
    assert len(dist.distance_points) > 3
    np.testing.assert_array_equal(outs[1], outs[0])
