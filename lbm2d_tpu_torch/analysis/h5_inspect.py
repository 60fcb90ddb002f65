"""Quick-look inspection of per-case HDF5 outputs (copy of
``lbm2d_tpu/analysis/h5_inspect.py``; h5py and matplotlib are imported at
first use).

CLI counterpart of the reference's exploratory notebooks
(notebooks/viz_result.ipynb: jet heatmaps of one turbulence channel, mask,
SDF and sum_vor plus the config_json attr; src/analysis/read.ipynb: the
dataset tree printer) so dataset inspection needs no notebook server on a
TPU host:

  python -m lbm2d_tpu_torch.analysis.h5_inspect outputs/P/raw            # tree
  python -m lbm2d_tpu_torch.analysis.h5_inspect case.h5 --plots --out d  # PNGs

The tree lists every dataset (shape/dtype/compression) and summarizes the
file attrs; --plots renders jet heatmaps of the selected turbulence frame's
channels plus the static/accumulated fields.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

# channel names of the turbulence dataset, matching the reference's MRT
# moment export order (LBM2D_MRT_LES.py:667-737)
CHANNEL_NAMES = ("rho", "e", "eps", "jx", "qx", "jy", "qy", "pxx", "pxy")


def _h5py():
    """h5py, imported at first use (an ImportError names it where it is
    missing)."""
    import h5py

    return h5py


def print_structure(path: Path) -> None:
    """Print every dataset's shape/dtype/compression and the file attrs."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        print(f"\n== {path}")

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                comp = obj.compression or "raw"
                print(f"  {name}: {obj.shape} {obj.dtype} [{comp}]")
            else:
                print(f"  {name}/")

        f.visititems(visit)
        for key in sorted(f.attrs):
            val = f.attrs[key]
            if key == "config_json":
                cfg = json.loads(val)
                sim = cfg.get("simulation", {})
                print(
                    "  @config_json: name=%s nu=%s grid=%sx%s"
                    % (
                        sim.get("name"),
                        sim.get("nu"),
                        sim.get("nx"),
                        sim.get("ny"),
                    )
                )
            else:
                with np.printoptions(precision=4, threshold=12):
                    print(f"  @{key}: {np.asarray(val)}")


def _save_jet(data: np.ndarray, title: str, out_png: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(
        data, cmap="jet", aspect="auto", origin="lower", interpolation="nearest"
    )
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    ax.set_xlabel("x (px)")
    ax.set_ylabel("y (px)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)


def render_plots(path: Path, out_dir: Path, frame: int = -1) -> list:
    """Jet heatmaps of one turbulence frame + the static/accumulated fields."""
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = path.stem
    written = []
    with _h5py().File(path, "r") as f:
        if "turbulence" in f and f["turbulence"].shape[0]:
            turb = f["turbulence"]
            t = frame if frame >= 0 else turb.shape[0] + frame
            for c in range(turb.shape[1]):
                name = CHANNEL_NAMES[c] if c < len(CHANNEL_NAMES) else f"ch{c}"
                png = out_dir / f"{stem}_t{t}_{name}.png"
                _save_jet(turb[t, c], f"{stem} turbulence[{t}] {name}", png)
                written.append(png)
        if "static_mask" in f:
            for i, name in enumerate(("mask", "sdf")):
                png = out_dir / f"{stem}_{name}.png"
                _save_jet(f["static_mask"][i], f"{stem} {name}", png)
                written.append(png)
        for dset in ("sum_vor", "mean_vel_sq_field"):
            if dset in f:
                png = out_dir / f"{stem}_{dset}.png"
                _save_jet(f[dset][:], f"{stem} {dset}", png)
                written.append(png)
        if "mean_vel_field" in f:
            mean = f["mean_vel_field"][:]
            for c in (3, 5):  # jx, jy
                if c < mean.shape[0]:
                    name = CHANNEL_NAMES[c]
                    png = out_dir / f"{stem}_mean_{name}.png"
                    _save_jet(mean[c], f"{stem} mean {name}", png)
                    written.append(png)
    return written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Inspect per-case HDF5 outputs.")
    ap.add_argument("path", help=".h5 file or a directory of them")
    ap.add_argument("--plots", action="store_true", help="render jet PNGs")
    ap.add_argument("--out", default=None, help="PNG directory (with --plots)")
    ap.add_argument(
        "--frame", type=int, default=-1,
        help="turbulence frame index for --plots (default: last)",
    )
    ap.add_argument(
        "--limit", type=int, default=4,
        help="max files to inspect when path is a directory",
    )
    args = ap.parse_args(argv)

    root = Path(args.path)
    files = (
        sorted(root.rglob("*.h5"))[: args.limit] if root.is_dir() else [root]
    )
    if not files:
        raise SystemExit(f"no .h5 files under {root}")
    for path in files:
        print_structure(path)
        if args.plots:
            out = Path(args.out) if args.out else path.parent / "inspect"
            for png in render_plots(path, out, args.frame):
                print(f"  wrote {png}")


if __name__ == "__main__":
    main()
