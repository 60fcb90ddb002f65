"""Environment doctor: `python -m lbm2d_tpu_torch.native`.

Counterpart of ``python -m lbm2d_tpu.native``. Reports what the current
host supports -- the pinned-package versions, PyTorch's CUDA build, the
CUDA devices it finds and ``nvcc``, whether the port's CUDA kernels
(``ops/cuda_build.py``) build and load, and the native C++ encode worker
(with its compiler error when it can't build) -- so a bring-up failure is
diagnosable without reading tracebacks. Exit code 0 even when optional
pieces are missing: only the Python stack in requirements.txt is mandatory.
It names only devices that PyTorch finds.
"""

from __future__ import annotations

import importlib.metadata as _md
import subprocess
import time

from . import build_error, load_videoenc

PACKAGES = ("torch", "numpy", "scipy", "h5py", "PyYAML", "opencv-python", "matplotlib",
            "zstandard", "pytest")
# distributions that provide the same module under another name
_ALTERNATIVES = {"opencv-python": ("opencv-python-headless",)}


def _version(pkg: str):
    for name in (pkg,) + _ALTERNATIVES.get(pkg, ()):
        try:
            return f"{_md.version(name)}" + ("" if name == pkg else f" ({name})")
        except _md.PackageNotFoundError:
            continue
    return None


def main() -> None:
    print("== lbm2d_tpu_torch environment check ==")

    print("\n[python packages]")
    for pkg in PACKAGES:
        v = _version(pkg)
        print(f"  {pkg:<16} {v or 'MISSING (pip install -r requirements.txt)'}")

    print("\n[cuda]")
    import torch

    print(f"  torch.version.cuda={torch.version.cuda}")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        print(f"  devices={n}")
        for i in range(n):
            print(f"  device {i}: {torch.cuda.get_device_name(i)}")
    else:
        print("  no CUDA device (torch.cuda.is_available() is False)")

    from ..ops import cuda_build

    try:
        nvcc = cuda_build.nvcc_path()
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        print(f"  nvcc: {nvcc}: {out[-1] if out else '(no output)'}")
    except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
        print(f"  nvcc: unavailable: {exc}")

    print("\n[cuda kernels]")
    t0 = time.perf_counter()
    try:
        cuda_build.build_all()
        for name in cuda_build.KERNELS:
            cuda_build.load(name)
        print(f"  OK: {', '.join(cuda_build.KERNELS)} built and loaded in "
              f"{time.perf_counter() - t0:.1f} s ({cuda_build.BUILD_DIR})")
    except (RuntimeError, OSError) as exc:  # doctor reports, never raises
        lines = str(exc).strip().splitlines()
        print(f"  unavailable: {lines[0] if lines else exc}")

    print("\n[native video encoder]")
    lib = load_videoenc()
    if lib is not None:
        print(f"  OK: backend={lib.venc_backend().decode()}")
    else:
        err = build_error() or "disabled (LBM2D_NO_NATIVE set?)"
        print("  unavailable -> cv2/imageio fallback will be used")
        print(f"  reason: {err.strip().splitlines()[-1] if err else err}")
        print("  (Debian: apt install g++ libavcodec-dev libavformat-dev "
              "libswscale-dev)")


if __name__ == "__main__":
    main()
