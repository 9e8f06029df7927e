from .assembly import QPTemplate, build_mpc_qp
from .ip import IPSpec, ip_solve, prepare_ip
from .ip_riccati import (IPSolution, RiccatiIPSpec, ip_riccati_solve,
                         prepare_ip_riccati)
from .qp import (ADMMSolution, ADMMSpec, ADMMState, admm_solve, apply_polish,
                 infeasibility_certificates, init_admm_state, polish_solution,
                 prepare_admm)
from .qp_cuda import admm_solve_cuda

__all__ = ["QPTemplate", "build_mpc_qp", "ADMMSpec", "ADMMState",
           "ADMMSolution", "prepare_admm", "admm_solve", "init_admm_state",
           "infeasibility_certificates", "polish_solution", "apply_polish",
           "admm_solve_cuda", "IPSpec", "prepare_ip", "ip_solve",
           "RiccatiIPSpec", "IPSolution", "prepare_ip_riccati",
           "ip_riccati_solve"]
