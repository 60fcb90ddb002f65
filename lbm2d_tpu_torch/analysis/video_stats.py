"""Video post-statistics: last frame + temporal average per output mp4.

Parity target: reference src/analysis/rans_calc.py -- walk the vis/
directories, extract the final frame and the mean-over-time frame of each
video as PNGs (a cheap RANS-style time average), skipping already-processed
files.

Usage:
  python -m lbm2d_tpu_torch.analysis.video_stats --root outputs [--overwrite]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np


def process_video(mp4_path: str, overwrite: bool = False) -> Optional[Tuple[str, str]]:
    """Write <stem>_last.png and <stem>_avg.png next to the video (needs
    cv2: an ImportError names it where it is missing)."""
    import cv2

    stem = os.path.splitext(mp4_path)[0]
    last_png = stem + "_last.png"
    avg_png = stem + "_avg.png"
    if not overwrite and os.path.exists(last_png) and os.path.exists(avg_png):
        return None

    cap = cv2.VideoCapture(mp4_path)
    if not cap.isOpened():
        return None
    acc = None
    count = 0
    last = None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        last = frame
        acc = frame.astype(np.float64) if acc is None else acc + frame
        count += 1
    cap.release()
    if last is None or count == 0:
        return None
    cv2.imwrite(last_png, last)
    cv2.imwrite(avg_png, (acc / count).astype(np.uint8))
    return last_png, avg_png


def walk_and_process(root: str, overwrite: bool = False) -> int:
    n = 0
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            if fname.endswith(".mp4"):
                if process_video(os.path.join(dirpath, fname), overwrite):
                    n += 1
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="outputs")
    ap.add_argument("--overwrite", action="store_true")
    args = ap.parse_args(argv)
    n = walk_and_process(args.root, args.overwrite)
    print(f"[Done] processed {n} videos under {args.root}")


if __name__ == "__main__":
    main()
