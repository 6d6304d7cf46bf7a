"""CLI entry point: python -m eincm_tpu.experiments [--config X] [k=v ...]

Equivalent of the reference's hydra entry
(src/experiments/e00/__main__.py:25-38):

    python -m eincm_tpu.experiments --config configs/ecd_slider.yaml \
        alpha=60 beta=60 dataset.des_n_events=30000 phases.plot=true
"""

from __future__ import annotations

import argparse

from eincm_tpu.experiments.config import load_config
from eincm_tpu.experiments.manager import EINCMExperiment
from eincm_tpu.utils.console import log


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="eincm_tpu.experiments",
        description="Run an EINCM experiment (solve / eval / plot phases).",
    )
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument(
        "overrides", nargs="*", help="dotted overrides, e.g. alpha=60"
    )
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    if cfg.distributed.enable:
        # must precede any backend touch (jax.distributed constraint)
        from eincm_tpu.parallel.distributed import (
            initialize_distributed,
            process_info,
        )

        initialize_distributed(cfg.distributed)
        log(process_info())
    from eincm_tpu.utils.jax_helpers import (
        enable_compilation_cache,
        update_jax_config,
    )

    enable_compilation_cache(cfg.compilation_cache_dir)
    if cfg.jax_config:
        update_jax_config(cfg.jax_config)
    log(f"experiment '{cfg.experiment_name}' on {cfg.dataset.kind}/"
        f"{cfg.dataset.sequence_name}")
    exp = EINCMExperiment(cfg)
    exp.run()
    return exp


if __name__ == "__main__":
    main()
