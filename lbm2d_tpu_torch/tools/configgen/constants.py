"""Physical constants and stability thresholds for case generation.

Single source of truth (reference tools/config_utils/constants.py:12-29).
"""

import math

# lattice sound speed
CS2 = 1.0 / 3.0
CS = math.sqrt(CS2)

# inlet Mach-number cap (u ~ 0.098 lu/step)
MA_LIMIT = 0.17

# BGK/MRT relaxation-time floor (nu_lb >= ~0.0067)
TAU_MIN = 0.52

# conservative velocity factor correcting the Bernoulli over-estimate
U_STEP_FACTOR = 0.6

# blockage-aware safety: max gap velocity, minimum open fraction
U_GAP_MAX = 0.15
MIN_OPEN = 0.20

# Reynolds cap for 2D urban LES stability
RE_MAX = 1200
