"""Config-generation package: master_config -> per-case YAMLs + config_meta.

Parity target: reference src/tools/config_utils/ package + config_batch_gen.py.
"""

from .constants import CS, CS2, MA_LIMIT, TAU_MIN, U_STEP_FACTOR, U_GAP_MAX, MIN_OPEN, RE_MAX
from .context import build_sim_context, build_mask_context
from .geometry import fill_geometry, calc_l_char, calc_max_blockage
from .feasibility import check_feasibility
from .blockage import fill_blockage_adj
from .nu_sampler import fill_nu_sample, get_all_feasible_nu
from .steps import fill_physics_and_steps
from .assembler import build_config
from .preview import print_re_preview, print_summary
