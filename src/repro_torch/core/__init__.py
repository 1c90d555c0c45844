"""RAQO core of the port: cost models, rule-based RAQO's decision tree,
Algorithm-1 hill climbing, the resource-plan cache, the session planning
broker, the Selinger and FastRandomized planners behind the ``RAQO``
facade, and the roofline and sharding planner of the accelerator
domain."""
from repro_torch.core.cluster import (ClusterConditions,  # noqa: F401
                                      PlanningStats, ResourceDim,
                                      paper_cluster, scaled_cluster)
from repro_torch.core.cost_model import (CostTable,  # noqa: F401
                                         HiveSimulator,
                                         RegressionModel, SimulatorCostModel,
                                         Surface, models_from_arrays,
                                         monetary_cost, paper_models,
                                         simulator_cost_models,
                                         simulator_models)
from repro_torch.core.decision_tree import (DecisionTree,  # noqa: F401
                                            default_hive_rule,
                                            default_spark_rule,
                                            train_raqo_tree)
from repro_torch.core.hillclimb import (argmin_grid, brute_force,  # noqa: F401
                                        enumerate_configs, hill_climb,
                                        hill_climb_multi)
from repro_torch.core.plan_broker import (PlanBroker, PlanFuture,  # noqa: F401
                                          PlanRequest)
from repro_torch.core.plan_cache import ResourcePlanCache  # noqa: F401
from repro_torch.core.planning_backend import (TorchPlanBackend,  # noqa: F401
                                               get_backend)
from repro_torch.core.plans import IMPLS, OperatorCosting, PlanNode  # noqa: F401
from repro_torch.core.raqo import RAQO, JointPlan  # noqa: F401
from repro_torch.core.schema import (Schema, TPCH_QUERIES,  # noqa: F401
                                     random_query, random_schema,
                                     schema_from_dict, tpch_schema)
from repro_torch.core.selinger import (exhaustive_left_deep,  # noqa: F401
                                       selinger_plan)
from repro_torch.core.fast_randomized import fast_randomized_plan  # noqa: F401
from repro_torch.core.roofline import (HW, Resources,  # noqa: F401
                                       RooflineCost, RooflineTerms,
                                       chip_seconds, terms_for, terms_grid)
from repro_torch.core.sharding_planner import (PLAN_CHOICES,  # noqa: F401
                                               ShardingDecision,
                                               ShardingPlanner, TpuCluster)
