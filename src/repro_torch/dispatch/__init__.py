"""Sparsity-adaptive SpMM / SDDMM dispatch (the port of
``repro.dispatch``): the policy vocabulary, the analytic cost model, the
timed autotune cache and ``calibrate``, the planners and the plan log, and
the legacy ``dispatch_spmm`` / ``dispatch_sddmm`` entry points.  The
reference's deprecated ``SparseOperand`` is not ported yet."""
from repro_torch.dispatch.autotune import (GLOBAL_CACHE, AutotuneCache,
                                           calibrate, make_key, measure)
from repro_torch.dispatch.cost_model import DEFAULT_COST_MODEL, CostModel
from repro_torch.dispatch.dispatcher import (Plan, clear_log, dispatch_log,
                                             dispatch_sddmm, dispatch_spmm,
                                             last_plan, log_capacity,
                                             plan_fused_attention,
                                             plan_sddmm, plan_spmm,
                                             record_plan,
                                             set_log_capacity)
from repro_torch.dispatch.policy import (DEFAULT_CONFIG, PATH_CSR,
                                         PATH_DENSE, PATH_ELL,
                                         PATH_FUSED_ATTN, PATH_SELL, PATHS,
                                         POLICIES, POLICY_AUTO,
                                         POLICY_AUTOTUNE, DispatchConfig,
                                         normalize_policy)
from repro_torch.dispatch.stats import MatrixStats, sparsity_bucket

__all__ = [
    "AutotuneCache", "GLOBAL_CACHE", "calibrate", "make_key", "measure",
    "CostModel", "DEFAULT_COST_MODEL",
    "Plan", "clear_log", "dispatch_log", "dispatch_sddmm", "dispatch_spmm",
    "last_plan", "log_capacity", "plan_fused_attention", "plan_sddmm",
    "plan_spmm", "record_plan", "set_log_capacity",
    "DEFAULT_CONFIG", "DispatchConfig", "PATHS", "PATH_CSR", "PATH_DENSE",
    "PATH_ELL", "PATH_FUSED_ATTN", "PATH_SELL", "POLICIES", "POLICY_AUTO",
    "POLICY_AUTOTUNE", "normalize_policy",
    "MatrixStats", "sparsity_bucket",
]
