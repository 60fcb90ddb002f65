"""Project directory contracts (reference pipeline/paths.py parity).

Inputs:  SimCases/{project}/{configs,masks}
Outputs: outputs/{project}/{raw,vis,plots}
"""

from __future__ import annotations

import os
from typing import Dict


def get_project_paths(project_name: str, root: str = ".") -> Dict[str, str]:
    base = os.path.join(root, "SimCases", project_name)
    return {
        "project_base": base,
        "configs": os.path.join(base, "configs"),
        "masks": os.path.join(base, "masks"),
        "outputs": os.path.join(root, "outputs", project_name),
    }


def setup_output_directories(base_output_path: str) -> Dict[str, str]:
    paths = {
        "base": base_output_path,
        "raw": os.path.join(base_output_path, "raw"),
        "vis": os.path.join(base_output_path, "vis"),
        "plots": os.path.join(base_output_path, "plots"),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths
