"""Simulation-wide scalar/vector type policy (PyTorch port of yasph2d_tpu/units.py).

Every particle attribute is float32, as in the reference (src/units.rs:2-4): the
DFSPH pressure solves iterate on density residuals that are small differences of
O(rho0) quantities, which a 16-bit type would destroy. Indices are int32.
"""

import numpy as np
import torch

# Scalar type used for all physical quantities (reference: src/units.rs:2).
REAL = torch.float32
# Host-side twin of REAL for scalar bookkeeping (dt, residual averages).
REAL_NP = np.float32

# Integer type for particle/cell indices.
INDEX = torch.int32

# Epsilon guarding divisions in kernel gradients (reference: smoothing_kernel/kernel.rs:9).
DIVISION_EPSILON = 1.0e-10
