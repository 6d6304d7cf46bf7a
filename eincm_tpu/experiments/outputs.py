"""Experiment artifact schema: opt_results.npz / eval_results.npz.

Reproduces the reference's validated nested-dict npz layout
(src/experiments/e00/outputs_loader.py:42-156,182-307) so downstream tools
(plotters, the DSEC submission exporter, score extraction) interoperate:

    opt_results['datasample_idx_{i}']['solver_final_results'][
        'prior_theta_pyr' | 'pre_opt_theta_pyr' | 'theta_opt_state_pyr' |
        'pre_handover_theta_pyr' | 'ho_opt_state_pyr' |
        'final_handover_weight_pyr' | 'final_theta_pyr']['pyr_lvl_{l}']

    eval_results['datasample_idx_{i}']['evals' | 'eval_ts' | 'eval_ts_units']
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from eincm_tpu.models.pyramid import SolveResult

FINAL_RESULT_KEYS = (
    "prior_theta_pyr",
    "pre_opt_theta_pyr",
    "theta_opt_state_pyr",
    "pre_handover_theta_pyr",
    "ho_opt_state_pyr",
    "final_handover_weight_pyr",
    "final_theta_pyr",
)

EVAL_REQUIRED_KEYS = (
    "loss", "iwe_var", "mean_rel_contrast", "mean_rel_corr", "theta_tot_var",
    "theta_div", "fwl", "mean_rel_iwe_div", "rel_iwe_divergences",
    "rel_contrasts", "rel_correlations", "flow_warp_losses",
    "multi_ref_weights",
)


def _pyr_dict(arrays) -> Dict[str, np.ndarray]:
    return {f"pyr_lvl_{i}": np.asarray(a) for i, a in enumerate(arrays)}


def solve_result_to_record(res: SolveResult) -> Dict:
    """Convert an on-device SolveResult into the npz record layout.

    The whole result pytree is fetched in ONE device_get — the naive
    per-field np.asarray conversion paid one host round-trip per leaf
    (~50 per window).
    """
    import jax

    res = jax.device_get(res)
    opt_states = {
        f"pyr_lvl_{i}": {
            "fun_val": np.asarray(s.fun_val),
            "iter_num": np.asarray(s.iter_num),
            "total_iters": np.asarray(s.total_iters),
            "n_fun_evals": np.asarray(s.n_fun_evals),
            "n_attempts": np.asarray(s.n_attempts),
            "success": np.asarray(s.success),
            "status": np.asarray(s.status),
        }
        for i, s in enumerate(res.theta_opt_states)
    }
    # the golden-section handover solve has no iteration state to report
    ho_states = {
        f"pyr_lvl_{i}": {"solved": True}
        for i in range(len(res.final_handover_weights))
    }
    return {
        "solver_final_results": {
            "prior_theta_pyr": _pyr_dict(res.prior_theta_pyr),
            "pre_opt_theta_pyr": _pyr_dict(res.pre_opt_theta_pyr),
            "theta_opt_state_pyr": opt_states,
            "pre_handover_theta_pyr": _pyr_dict(res.pre_handover_theta_pyr),
            "ho_opt_state_pyr": ho_states,
            "final_handover_weight_pyr": _pyr_dict(res.final_handover_weights),
            "final_theta_pyr": _pyr_dict(res.final_theta_pyr),
        },
        "solver_intermediate_results": {
            "theta_opt": {
                "n_iters": {
                    k: v["iter_num"] for k, v in opt_states.items()
                },
                **(
                    {
                        "thetas": {
                            f"pyr_lvl_{i}": np.asarray(h.xs)[: int(h.n)]
                            for i, h in enumerate(res.theta_histories)
                        },
                        "losses": {
                            f"pyr_lvl_{i}": np.asarray(h.fs)[: int(h.n)]
                            for i, h in enumerate(res.theta_histories)
                        },
                    }
                    if res.theta_histories
                    else {}
                ),
            },
            "handover_opt": {
                "n_iters": {
                    f"pyr_lvl_{i}": np.asarray(
                        int(h.n) if h is not None else 0
                    )
                    for i, h in enumerate(
                        res.handover_histories
                        or [None] * len(res.final_handover_weights)
                    )
                },
                **(
                    {
                        "weights": {
                            f"pyr_lvl_{i}": np.asarray(h.xs)[: int(h.n)]
                            for i, h in enumerate(res.handover_histories)
                            if h is not None
                        },
                        "losses": {
                            f"pyr_lvl_{i}": np.asarray(h.fs)[: int(h.n)]
                            for i, h in enumerate(res.handover_histories)
                            if h is not None
                        },
                    }
                    if any(h is not None for h in res.handover_histories)
                    else {}
                ),
            },
        },
    }


def save_opt_results(path, opt_results: Dict, cfg: Optional[Dict] = None):
    np.savez(path, opt_results=opt_results, cfg=cfg or {})


def save_eval_results(path, eval_results: Dict, cfg: Optional[Dict] = None):
    np.savez(path, eval_results=eval_results, cfg=cfg or {})


def validate_opt_results(opt_results: Dict, n_pyr_lvls: Optional[int] = None):
    assert isinstance(opt_results, dict)
    for k0, rec in opt_results.items():
        assert k0.startswith("datasample_idx_"), k0
        assert "solver_final_results" in rec and "solver_intermediate_results" in rec
        fin = rec["solver_final_results"]
        for k2 in FINAL_RESULT_KEYS:
            assert k2 in fin, (k0, k2)
            if n_pyr_lvls is not None:
                assert len(fin[k2]) == n_pyr_lvls, (k0, k2)
            assert all(k3.startswith("pyr_lvl_") for k3 in fin[k2]), (k0, k2)


def validate_eval_results(eval_results: Dict):
    assert isinstance(eval_results, dict)
    for k0, rec in eval_results.items():
        assert k0.startswith("datasample_idx_"), k0
        for k1 in ("evals", "eval_ts", "eval_ts_units"):
            assert k1 in rec, (k0, k1)
        for k2 in EVAL_REQUIRED_KEYS:
            assert k2 in rec["evals"], (k0, k2)


class EINCMOutputLoader:
    """Load + validate experiment artifacts (reference: outputs_loader.py:8-319)."""

    def __init__(self):
        self.opt_results = None
        self.eval_results = None
        self.cfg = None

    def load_opt_results(self, opt_path, run_validation=True, load_cfg=True):
        p = Path(opt_path)
        assert p.exists() and p.suffix == ".npz", p
        data = np.load(p, allow_pickle=True)
        self.opt_results = data["opt_results"].item()
        if load_cfg and "cfg" in data:
            self.cfg = data["cfg"].item()
        if run_validation:
            validate_opt_results(self.opt_results)
        return self.opt_results

    def load_eval_results(self, eval_path, run_validation=True, load_cfg=False):
        p = Path(eval_path)
        assert p.exists() and p.suffix == ".npz", p
        data = np.load(p, allow_pickle=True)
        self.eval_results = data["eval_results"].item()
        if load_cfg and "cfg" in data:
            self.cfg = data["cfg"].item()
        if run_validation:
            validate_eval_results(self.eval_results)
        return self.eval_results
