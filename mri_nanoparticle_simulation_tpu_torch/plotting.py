"""Publication plots for the simulator's CSV products (``mri-t2-plot``).

The reference's data product is a bare CSV eyeballed in external tools
(README.md:16 suggests gnuplot-style offline plotting); this module
closes the loop: decay curves (the reference schema ``time_ms,sum_cos``
with our optional quadrature column) and fitted dispersion tables
(``--fit-t2`` / ``--fit-r2`` output) render to PNG with a consistent,
colorblind-validated style.

The port's copy of the reference package's ``plotting.py``: the same
code, reading through the port's own ``io.writer.read_t2_csv`` and
``scene.io.read_scene_arrays``, so both packages draw the same pixels
from the same files (``python -m
mri_nanoparticle_simulation_tpu_torch.plotting``).  It needs matplotlib
(the ``Agg`` backend) and nothing of torch.

Style notes (the repo-wide data-viz conventions):

* one chart form per job — decay curves are change-over-time (lines);
  dispersion tables are a few ordered numeric points (line + markers);
* ONE y-axis per figure, never a dual axis;
* categorical series colors come from a fixed, validated palette and
  are assigned in slot order (never cycled, never rainbow);
* thin 2-pt lines, recessive grid, text in ink colors (never the series
  color), a legend whenever there are >= 2 series (a single series is
  named by the title instead).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

#: fixed categorical slot order (validated default palette: lightness
#: band, chroma floor, CVD-pair and normal-vision separation, contrast
#: per surface — see the palette's provenance note).  The dark column
#: is the SAME hues re-stepped for the dark surface and validated as a
#: set — a selected mode, not an automatic flip.
class Theme:
    def __init__(self, series, surface, ink, ink2, grid):
        self.series, self.surface = series, surface
        self.ink, self.ink2, self.grid = ink, ink2, grid


LIGHT = Theme(["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
               "#e87ba4", "#008300", "#4a3aa7"],
              "#fcfcfb", "#0b0b0b", "#52514e", "#e4e3df")
DARK = Theme(["#3987e5", "#d95926", "#199e70", "#c98500",
              "#d55181", "#008300", "#9085e9"],
             "#1a1a19", "#ffffff", "#c3c2b7", "#3a3a38")
#: back-compat module aliases (light mode)
SERIES, SURFACE = LIGHT.series, LIGHT.surface
INK, INK_2, GRID = LIGHT.ink, LIGHT.ink2, LIGHT.grid


def _style_axes(ax, th: Theme):
    ax.set_facecolor(th.surface)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(th.grid)
    ax.tick_params(colors=th.ink2, labelsize=9)
    ax.grid(True, color=th.grid, linewidth=0.6, alpha=0.8)
    ax.set_axisbelow(True)


def _series_label(path: str) -> str:
    base = os.path.splitext(os.path.basename(path))[0]
    return base


def plot_curves(csv_paths: Sequence[str], out_png: str,
                num_water: Optional[int] = None,
                title: Optional[str] = None,
                logy: bool = False, dark: bool = False,
                magnitude: bool = False) -> str:
    """One decay-curve figure: each CSV (reference schema, cos column)
    becomes a line.  ``num_water`` normalizes sum_cos to m(t) in [0, 1];
    omitted, the raw sums are plotted.  ``magnitude`` plots
    |M| = sqrt(cos^2 + sin^2) instead (requires the --quadrature
    column)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    th = DARK if dark else LIGHT
    if len(csv_paths) > len(th.series):
        raise ValueError(
            f"{len(csv_paths)} curves exceed the fixed "
            f"{len(th.series)}-slot palette; fold extra runs into "
            f"separate figures (hues are never generated or cycled)")
    fig, ax = plt.subplots(figsize=(7.0, 4.2), dpi=160)
    fig.patch.set_facecolor(th.surface)
    _style_axes(ax, th)
    from .io.writer import read_t2_csv
    for i, path in enumerate(csv_paths):
        cols = read_t2_csv(path)
        if magnitude:
            if len(cols) < 3:
                raise ValueError(
                    f"{path} has no quadrature (sum_sin) column; "
                    f"--magnitude needs a --quadrature CSV")
            y = np.hypot(cols[1], cols[2]) / (num_water or 1)
        else:
            y = cols[1] / (num_water or 1)
        ax.plot(cols[0], y, color=th.series[i], linewidth=2.0,
                label=_series_label(path))
    ax.set_xlabel("time (ms)", color=th.ink2, fontsize=10)
    ylab = "|M(t)|" if magnitude else "m(t) = Σcos φ"
    ax.set_ylabel(ylab + (" / W" if num_water else ""),
                  color=th.ink2, fontsize=10)
    if logy:
        ax.set_yscale("log")
    if title:
        ax.set_title(title, color=th.ink, fontsize=12, loc="left")
    if len(csv_paths) >= 2:
        leg = ax.legend(frameon=False, fontsize=9, loc="best")
        for t in leg.get_texts():
            t.set_color(th.ink)
    fig.tight_layout()
    fig.savefig(out_png, facecolor=th.surface)
    plt.close(fig)
    return out_png


def plot_dispersion(table_path: str, out_png: str,
                    ycol: str = "r2_per_ms",
                    title: Optional[str] = None,
                    dark: bool = False) -> str:
    """Dispersion-table figure (``--fit-t2`` / ``--fit-r2`` output):
    ``ycol`` against the knob column with the most distinct values;
    the remaining knob columns (a --sweep-grid surface, or --fit-r2's
    mscale) each get one line per distinct value combination.  nan
    rows (unfittable points) are dropped from their series."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(table_path) as f:
        rows = list(csv.reader(f))
    header, data = rows[0], rows[1:]
    fit_cols = ("r2_per_ms", "t2_ms", "r_squared", "n_echoes",
                "t2_stderr_ms", "t2_lo_ms", "t2_hi_ms", "n_ok")
    knobs = [c for c in header if c not in fit_cols]
    if not knobs:
        raise ValueError(f"no knob columns in {table_path} ({header})")
    if ycol not in header:
        raise ValueError(f"column {ycol!r} not in {table_path} ({header})")
    # the x axis is the knob with the MOST distinct values — for the
    # --fit-r2 schema (mscale,taucp_ms,...) with one mscale that is the
    # taucp axis, for a 1-knob --fit-t2 table it is that knob, and for
    # a grid surface the denser axis; the sparser knobs become series
    def distinct(col):
        j = header.index(col)
        return len({r[j] for r in data})
    x_knob = max(knobs, key=distinct)
    rest_knobs = [k for k in knobs if k != x_knob]
    xi = header.index(x_knob)
    yi = header.index(ycol)
    rest = [header.index(k) for k in rest_knobs]

    # 1-sigma error bars when the table carries t2_stderr_ms (newer
    # builds): direct for t2_ms, propagated (se/t2^2) for r2_per_ms
    se_i = header.index("t2_stderr_ms") if "t2_stderr_ms" in header else None
    t2_i = header.index("t2_ms") if "t2_ms" in header else None

    def _yerr(r):
        if se_i is None or ycol not in ("t2_ms", "r2_per_ms"):
            return float("nan")
        se = float(r[se_i])
        if ycol == "t2_ms":
            return se
        t2 = float(r[t2_i])
        return se / (t2 * t2)

    th = DARK if dark else LIGHT
    groups: dict = {}
    for r in data:
        key = tuple(r[j] for j in rest)
        groups.setdefault(key, []).append(
            (float(r[xi]), float(r[yi]), _yerr(r)))
    if len(groups) > len(th.series):
        raise ValueError(
            f"{len(groups)} series exceed the fixed "
            f"{len(th.series)}-slot palette; facet the surface into "
            f"multiple figures instead")

    fig, ax = plt.subplots(figsize=(6.0, 4.0), dpi=160)
    fig.patch.set_facecolor(th.surface)
    _style_axes(ax, th)
    for i, (key, pts) in enumerate(groups.items()):
        pts = sorted(p for p in pts if np.isfinite(p[1]))
        if not pts:
            continue
        xs, ys, es = zip(*pts)
        label = ", ".join(f"{k}={v}" for k, v in zip(rest_knobs, key)) \
            or ycol
        if any(np.isfinite(e) and e > 0 for e in es):
            ax.errorbar(xs, ys,
                        yerr=[e if np.isfinite(e) else 0.0 for e in es],
                        color=th.series[i], linewidth=2.0, marker="o",
                        markersize=5.5, label=label, capsize=2.5,
                        elinewidth=1.0)
        else:
            ax.plot(xs, ys, color=th.series[i], linewidth=2.0, marker="o",
                    markersize=5.5, label=label)
    ax.set_xlabel(x_knob, color=th.ink2, fontsize=10)
    unit = {"r2_per_ms": "R2 (1/ms)", "t2_ms": "T2 (ms)",
            "r_squared": "fit R²", "n_echoes": "echoes",
            "t2_stderr_ms": "T2 sigma (ms)"}.get(ycol, ycol)
    ax.set_ylabel(unit, color=th.ink2, fontsize=10)
    if title:
        ax.set_title(title, color=th.ink, fontsize=12, loc="left")
    if len(groups) >= 2:
        leg = ax.legend(frameon=False, fontsize=9, loc="best")
        for t in leg.get_texts():
            t.set_color(th.ink)
    fig.tight_layout()
    fig.savefig(out_png, facecolor=th.surface)
    plt.close(fig)
    return out_png


def plot_scene(scene_npz: str, out_png: str,
               title: Optional[str] = None, dark: bool = False,
               max_waters: int = 2000) -> str:
    """Scene-geometry figure from a scene .npz archive
    (``mri-t2-sim --save-scene`` / ``scene.save_scene``): three
    orthogonal projections (XY, XZ, YZ) of the cells (circles at true
    cell_r scale), the MNP periodic images outside the box (small
    crosses), and the initial walker positions (dots).  The reference's
    workflow here was dumping ``simulation_stats.csv`` and eyeballing it
    in external tools (SimulationBox.cpp:214-237, SimboxTest.cpp).

    ``max_waters`` subsamples the walker dots deterministically (every
    k-th) so scale-up scenes stay legible."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    from .scene.io import read_scene_arrays
    cells, mnps, waters, n_intra, fields = read_scene_arrays(scene_npz)
    try:
        cell_r = float(fields["cell_r"])
        bound = float(fields["bound"])
    except KeyError:
        raise ValueError(f"{scene_npz} carries no geometry record "
                         f"(geom_repr); re-save it with this build's "
                         f"scene.save_scene / --save-scene")
    if len(waters) > max_waters:
        waters = waters[:: int(np.ceil(len(waters) / max_waters))]

    th = DARK if dark else LIGHT
    images = mnps[n_intra:]
    lo = min(0.0, images[:, :3].min() if len(images) else 0.0)
    hi = max(bound, images[:, :3].max() if len(images) else bound)
    pad = 0.02 * (hi - lo)
    fig, axes = plt.subplots(1, 3, figsize=(12.0, 4.3), dpi=160)
    fig.patch.set_facecolor(th.surface)
    planes = (("x", "y", 0, 1), ("x", "z", 0, 2), ("y", "z", 1, 2))
    for ax, (nx, ny, i, j) in zip(axes, planes):
        _style_axes(ax, th)
        ax.set_aspect("equal")
        ax.set_xlim(lo - pad, hi + pad)
        ax.set_ylim(lo - pad, hi + pad)
        # the periodic box outline (ink, recessive)
        ax.plot([0, bound, bound, 0, 0], [0, 0, bound, bound, 0],
                color=th.grid, linewidth=1.0)
        for c in cells:
            ax.add_patch(Circle((c[i], c[j]), cell_r, fill=False,
                                edgecolor=th.series[0], linewidth=1.2,
                                alpha=0.9))
        if len(images):
            ax.scatter(images[:, i], images[:, j], s=8, marker="+",
                       color=th.ink2, linewidths=0.8, alpha=0.7)
        ax.scatter(waters[:, i], waters[:, j], s=2.5, marker="o",
                   color=th.series[1], alpha=0.45, edgecolors="none")
        ax.set_xlabel(f"{nx} (µm)", color=th.ink2, fontsize=10)
        ax.set_ylabel(f"{ny} (µm)", color=th.ink2, fontsize=10)
    if title is None:
        title = (f"{len(cells)} cells (r = {cell_r:g} µm), "
                 f"{len(images)} periodic images, "
                 f"{len(waters)} walkers shown")
    fig.suptitle(title, color=th.ink, fontsize=12, x=0.01, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.94))
    fig.savefig(out_png, facecolor=th.surface)
    plt.close(fig)
    return out_png


def plot_spectrum(table_paths: Sequence[str], out_png: str,
                  title: Optional[str] = None, dark: bool = False) -> str:
    """T2-spectrum figure (``mri-t2-fit --spectrum --out-table``
    product: ``t2_ms,weight`` rows): amplitude density over a log T2
    axis, one line per table."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    th = DARK if dark else LIGHT
    if len(table_paths) > len(th.series):
        raise ValueError(
            f"{len(table_paths)} spectra exceed the fixed "
            f"{len(th.series)}-slot palette; fold extra runs into "
            f"separate figures (hues are never generated or cycled)")
    fig, ax = plt.subplots(figsize=(6.5, 4.0), dpi=160)
    fig.patch.set_facecolor(th.surface)
    _style_axes(ax, th)
    for i, path in enumerate(table_paths):
        with open(path) as f:
            header = f.readline().strip().split(",")
        if header[:2] != ["t2_ms", "weight"]:
            raise ValueError(f"{path} is not a spectrum table "
                             f"(want t2_ms,weight; got {header})")
        rows = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
        ax.plot(rows[:, 0], rows[:, 1], color=th.series[i],
                linewidth=2.0, label=_series_label(path))
        ax.fill_between(rows[:, 0], rows[:, 1], color=th.series[i],
                        alpha=0.15, linewidth=0)
    ax.set_xscale("log")
    ax.set_xlabel("T2 (ms)", color=th.ink2, fontsize=10)
    ax.set_ylabel("amplitude", color=th.ink2, fontsize=10)
    if title:
        ax.set_title(title, color=th.ink, fontsize=12, loc="left")
    if len(table_paths) >= 2:
        leg = ax.legend(frameon=False, fontsize=9, loc="best")
        for t in leg.get_texts():
            t.set_color(th.ink)
    fig.tight_layout()
    fig.savefig(out_png, facecolor=th.surface)
    plt.close(fig)
    return out_png


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Plot simulator CSV products: decay curves, "
                    "fitted dispersion tables, T2 spectra, or scene "
                    "geometry -> PNG")
    ap.add_argument("inputs", nargs="+",
                    help="T2 CSVs (decay curves, one line each) or, "
                         "with --table, ONE dispersion table")
    ap.add_argument("--out", required=True, help="output PNG path")
    ap.add_argument("--table", action="store_true",
                    help="inputs[0] is a --fit-t2/--fit-r2 dispersion "
                         "table (r2/t2 vs the swept knob) instead of "
                         "decay CSVs")
    ap.add_argument("--scene", action="store_true",
                    help="inputs[0] is a scene .npz archive "
                         "(mri-t2-sim --save-scene): render the "
                         "geometry — cells, periodic MNP images, "
                         "walker starts — in three projections")
    ap.add_argument("--spectrum", action="store_true",
                    help="inputs are T2-spectrum tables (mri-t2-fit "
                         "--spectrum --out-table, t2_ms,weight rows): "
                         "amplitude density over a log T2 axis")
    ap.add_argument("--ycol", default="r2_per_ms",
                    choices=["r2_per_ms", "t2_ms", "r_squared"],
                    help="table column to plot (with --table)")
    ap.add_argument("--num-water", type=int, default=None,
                    help="normalize sum_cos by the walker count")
    ap.add_argument("--title", default=None)
    ap.add_argument("--logy", action="store_true",
                    help="log magnetization axis (decay curves)")
    ap.add_argument("--magnitude", action="store_true",
                    help="plot |M| = sqrt(cos^2 + sin^2) (decay curves "
                         "with the --quadrature column)")
    ap.add_argument("--dark", action="store_true",
                    help="dark mode: the same hues re-stepped for the "
                         "dark surface (a selected palette column, not "
                         "an inverted one)")
    args = ap.parse_args(argv)

    if sum((args.table, args.scene, args.spectrum)) > 1:
        ap.error("--table/--scene/--spectrum are different inputs; "
                 "pick one")
    if args.spectrum:
        if args.magnitude or args.logy:
            ap.error("--magnitude/--logy apply to decay curves, "
                     "not spectra")
        plot_spectrum(args.inputs, args.out, title=args.title,
                      dark=args.dark)
    elif args.scene:
        if len(args.inputs) != 1:
            ap.error("--scene plots ONE scene archive")
        if args.magnitude or args.logy:
            ap.error("--magnitude/--logy apply to decay curves, "
                     "not scene geometry")
        plot_scene(args.inputs[0], args.out, title=args.title,
                   dark=args.dark)
    elif args.table:
        if len(args.inputs) != 1:
            ap.error("--table plots ONE dispersion table")
        if args.magnitude:
            ap.error("--magnitude applies to decay curves, not tables")
        plot_dispersion(args.inputs[0], args.out, ycol=args.ycol,
                        title=args.title, dark=args.dark)
    else:
        plot_curves(args.inputs, args.out, num_water=args.num_water,
                    title=args.title, logy=args.logy, dark=args.dark,
                    magnitude=args.magnitude)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
