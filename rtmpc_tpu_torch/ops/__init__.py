from .assembly import QPTemplate, build_mpc_qp
from .qp import (ADMMSolution, ADMMSpec, ADMMState, admm_solve,
                 init_admm_state, prepare_admm)
from .qp_cuda import admm_solve_cuda

__all__ = ["QPTemplate", "build_mpc_qp", "ADMMSpec", "ADMMState",
           "ADMMSolution", "prepare_admm", "admm_solve", "init_admm_state",
           "admm_solve_cuda"]
