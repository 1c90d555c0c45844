"""RAQO end to end on the PyTorch port: the paper's four optimizer modes
in both domains (``examples/raqo_plan.py``'s calls and lines on
``repro_torch``).

  DB domain : joint (join order + operator impls + container resources)
              on TPC-H, with hill climbing + plan caching.
  TPU domain: joint (parallelism plan + mesh resources) for assigned
              architectures, same Algorithm 1 + cache machinery.

    PYTHONPATH=src python examples/port_raqo_plan.py [--device cpu]

The searches run on the CUDA kernels (``--device cuda``, the default;
without a GPU it raises) or on the exact float64 torch backend
(``--device cpu``), whose plans and costs are the reference's numpy
backend's bit for bit.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.core import (RAQO, ResourcePlanCache,  # noqa: E402
                              TPCH_QUERIES, simulator_cost_models,
                              tpch_schema)
from repro_torch.core.roofline import Resources  # noqa: E402
from repro_torch.core.sharding_planner import ShardingPlanner  # noqa: E402


def db_domain(backend):
    print("=" * 72)
    print("DB domain (the paper's own evaluation)")
    print("=" * 72)
    raqo = RAQO(schema=tpch_schema(100), models=simulator_cost_models(),
                cache=ResourcePlanCache("nearest_neighbor", 0.1),
                backend=backend)
    jp = raqo.joint(TPCH_QUERIES["Q3"])
    print(f"=> (p, r) on Q3: {jp.exec_time:.2f}s  ${jp.money:.4f}  "
          f"planner {jp.planner_seconds*1e3:.1f}ms  "
          f"configs {jp.stats.configs_explored}")
    print(jp.plan.describe())
    quota = raqo.plan_for_resources(TPCH_QUERIES["Q3"], (20, 4))
    print(f"r => p  (20 containers x 4GB quota): {quota.exec_time:.2f}s")
    res, money = raqo.resources_for_plan(jp.plan, target_time=30.0)
    print(f"p => (r, c)  (SLA 30s): root-op resources {res}, ${money:.4f}")
    budget = raqo.for_budget(TPCH_QUERIES["Q3"], budget=0.05)
    print(f"c => (p, r)  ($0.05 budget): {budget.exec_time:.2f}s "
          f"${budget.money:.4f}")


def tpu_domain(backend):
    print("=" * 72)
    print("TPU domain (the framework transfer)")
    print("=" * 72)
    planner = ShardingPlanner(cache=ResourcePlanCache("nearest_neighbor",
                                                      1e6), backend=backend)
    for arch in ("deepseek-67b", "qwen3-moe-30b-a3b", "falcon-mamba-7b"):
        for shape in ("train_4k", "decode_32k"):
            d = planner.joint(get_config(arch), get_shape(shape), arch=arch)
            print(d.describe())
    print("-" * 72)
    d = planner.plan_for_resources(get_config("deepseek-67b"),
                                   get_shape("train_4k"),
                                   Resources(1, 16, 16, 4))
    print("r => p (fixed 256 chips):", d.describe())
    d = planner.replan(get_config("deepseek-67b"), get_shape("train_4k"),
                       lost_chips=256)
    print("adaptive RAQO (lost 256 chips):", d.describe())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU): the "
                         "kernels; cpu: the exact torch backend")
    args = ap.parse_args(argv)
    backend = "torch" if args.device == "cpu" else "cuda"
    db_domain(backend)
    tpu_domain(backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
