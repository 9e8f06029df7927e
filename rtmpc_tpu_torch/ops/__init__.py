from .assembly import QPTemplate, build_mpc_qp
from .ip_riccati import (IPSolution, RiccatiIPSpec, ip_riccati_solve,
                         prepare_ip_riccati)
from .qp import (ADMMSolution, ADMMSpec, ADMMState, admm_solve,
                 infeasibility_certificates, init_admm_state, prepare_admm)
from .qp_cuda import admm_solve_cuda

__all__ = ["QPTemplate", "build_mpc_qp", "ADMMSpec", "ADMMState",
           "ADMMSolution", "prepare_admm", "admm_solve", "init_admm_state",
           "infeasibility_certificates", "admm_solve_cuda", "RiccatiIPSpec",
           "IPSolution", "prepare_ip_riccati", "ip_riccati_solve"]
