"""File housekeeping tools: bulk mask rename, codebase export, output backup.

Parity targets: reference src/tools/rename_files.py (masks -> mask_NN.png),
export_code_base.py (dump source tree to one txt), src/tools/backup_to_drive.py
(copy configs/masks/summaries/h5 to a backup root).

Usage:
  python -m lbm2d_tpu_torch.tools.file_ops rename --dir SimCases/P/masks
  python -m lbm2d_tpu_torch.tools.file_ops export --root . --out codebase.txt
  python -m lbm2d_tpu_torch.tools.file_ops backup --project_name P --dest /backup
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import List, Optional


def rename_masks(mask_dir: str, prefix: str = "mask", dry_run: bool = False) -> List[str]:
    """Rename every PNG in mask_dir to {prefix}_{NN}.png, sorted order."""
    pngs = sorted(f for f in os.listdir(mask_dir) if f.endswith(".png"))
    renamed = []
    for idx, fname in enumerate(pngs):
        new = f"{prefix}_{idx:02d}.png"
        if fname == new:
            continue
        if not dry_run:
            os.rename(os.path.join(mask_dir, fname), os.path.join(mask_dir, new))
        renamed.append(f"{fname} -> {new}")
    return renamed


_EXPORT_EXTS = (".py", ".yaml", ".yml", ".md", ".json", ".toml")
_SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "outputs", "SimCases", ".claude"}


def export_codebase(root: str, out_path: str, exts=_EXPORT_EXTS) -> int:
    """Concatenate the source tree into one annotated text file."""
    count = 0
    with open(out_path, "w", encoding="utf-8") as out:
        for dirpath, dirs, files in os.walk(root):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            for fname in sorted(files):
                if not fname.endswith(exts):
                    continue
                path = os.path.join(dirpath, fname)
                rel = os.path.relpath(path, root)
                out.write(f"\n{'=' * 70}\n# FILE: {rel}\n{'=' * 70}\n")
                try:
                    with open(path, "r", encoding="utf-8", errors="replace") as fh:
                        out.write(fh.read())
                    count += 1
                except OSError as exc:
                    out.write(f"[unreadable: {exc}]\n")
    return count


def backup_project(
    project_name: str,
    dest_root: str,
    root: str = ".",
    include_h5: bool = True,
) -> List[str]:
    """Copy a project's configs, masks, summaries (and optionally raw h5)."""
    copied = []
    pairs = [
        (os.path.join(root, "SimCases", project_name, "configs"), "configs"),
        (os.path.join(root, "SimCases", project_name, "masks"), "masks"),
        (os.path.join(root, "outputs", project_name, "plots"), "plots"),
    ]
    if include_h5:
        pairs.append((os.path.join(root, "outputs", project_name, "raw"), "raw"))
    dest_base = os.path.join(dest_root, project_name)
    for src, name in pairs:
        if not os.path.isdir(src):
            continue
        dst = os.path.join(dest_base, name)
        os.makedirs(dst, exist_ok=True)
        for fname in sorted(os.listdir(src)):
            s = os.path.join(src, fname)
            if os.path.isfile(s):
                shutil.copy2(s, os.path.join(dst, fname))
                copied.append(os.path.join(name, fname))
    # config_meta.json sits next to the configs dir
    meta = os.path.join(root, "SimCases", project_name, "config_meta.json")
    if os.path.exists(meta):
        os.makedirs(dest_base, exist_ok=True)
        shutil.copy2(meta, os.path.join(dest_base, "config_meta.json"))
        copied.append("config_meta.json")
    return copied


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="File housekeeping tools.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("rename")
    r.add_argument("--dir", required=True)
    r.add_argument("--prefix", default="mask")
    r.add_argument("--dry-run", action="store_true")
    e = sub.add_parser("export")
    e.add_argument("--root", default=".")
    e.add_argument("--out", default="codebase_export.txt")
    b = sub.add_parser("backup")
    b.add_argument("--project_name", required=True)
    b.add_argument("--dest", required=True)
    b.add_argument("--no-h5", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "rename":
        for line in rename_masks(args.dir, args.prefix, args.dry_run):
            print(line)
    elif args.cmd == "export":
        n = export_codebase(args.root, args.out)
        print(f"[Done] {n} files -> {args.out}")
    else:
        copied = backup_project(args.project_name, args.dest, include_h5=not args.no_h5)
        print(f"[Done] {len(copied)} files -> {args.dest}/{args.project_name}")


if __name__ == "__main__":
    main()
