"""ISLA core, PyTorch port — the public API of this slice.

Host path (float64, numpy): engine.aggregate / run_block, MomentStore and
the multi-query executor's ``route="host"`` — copies of the reference's
host code.  Device path (fp32, torch, ``cuda`` unless ``device="cpu"``):
DeviceMomentStore / DeviceStack and ``route="device"``, whose serving tick
folds samples through the hand-written CUDA kernels; MeshDeviceStack and
``route="mesh"`` run that tick on every shard of a cell mesh.
"""
from .types import (AggregateResult, Anchor, BlockResult, BlockResultsBatch,
                    Boundaries, IslaParams, Predicate, RegionMoments,
                    StoreKey, ZoneMap, REGION_TS, REGION_S, REGION_N,
                    REGION_L, REGION_TL, ZONE_EMPTY, ZONE_FULL,
                    ZONE_PARTIAL, classify, classify_np, region_of)
from .boundaries import (choose_q, choose_q_batch, deviation_degree,
                         deviation_degree_batch, is_balanced,
                         is_balanced_batch, make_boundaries)
from .estimator import (l_estimator, l_estimator_direct, theorem3_kc,
                        theorem3_kc_batch)
from .modulation import (lambda_star, run_modulation, solve_calibrated,
                         solve_calibrated_batch, solve_closed_form,
                         solve_closed_form_batch, solve_empirical_batch,
                         classify_case, classify_case_batch, n_iterations,
                         n_iterations_batch, ModulationBatchResult,
                         CASE_BALANCED)
from .preestimation import (array_sampler, distribution_sampler, run_pilot,
                            required_sample_size, sampling_rate, z_score)
from .engine import (IslaQuery, aggregate, aggregate_array, baseline_sample,
                     flat_segments, phase1_sampling, phase1_sampling_batch,
                     phase2_iteration, phase2_iteration_batch, run_block,
                     run_blocks_batched, sample_blocks_batched,
                     sample_moments_batch)
from .summarize import summarize
from .baselines import mv_avg, mvb_avg, uniform_avg
from .moment_store import (DeviceMomentStore, DeviceStack, MeshDeviceStack,
                           MomentStore, iter_chunked_draws, split_budget)
from .multiquery import (GroupAnswer, MultiQueryExecutor, QueryAnswer,
                         QueryPlan, multi_aggregate, table_sampler)
from . import distributed

__all__ = [
    "AggregateResult", "Anchor", "BlockResult", "BlockResultsBatch",
    "Boundaries",
    "IslaParams", "IslaQuery", "Predicate", "flat_segments",
    "RegionMoments", "REGION_TS", "REGION_S", "REGION_N", "REGION_L",
    "REGION_TL", "ZoneMap", "ZONE_EMPTY", "ZONE_FULL", "ZONE_PARTIAL",
    "classify", "classify_np", "region_of", "choose_q",
    "choose_q_batch", "deviation_degree", "deviation_degree_batch",
    "is_balanced", "is_balanced_batch", "make_boundaries", "l_estimator",
    "l_estimator_direct", "theorem3_kc", "theorem3_kc_batch", "lambda_star",
    "run_modulation", "solve_calibrated", "solve_calibrated_batch",
    "solve_closed_form", "solve_closed_form_batch", "solve_empirical_batch",
    "classify_case", "classify_case_batch", "n_iterations",
    "n_iterations_batch", "ModulationBatchResult",
    "CASE_BALANCED", "array_sampler", "distribution_sampler", "run_pilot",
    "required_sample_size", "sampling_rate", "z_score", "aggregate",
    "aggregate_array", "baseline_sample", "phase1_sampling",
    "phase1_sampling_batch", "phase2_iteration", "phase2_iteration_batch",
    "run_block", "run_blocks_batched", "sample_blocks_batched",
    "sample_moments_batch", "summarize",
    "mv_avg", "mvb_avg", "uniform_avg", "MomentStore", "DeviceMomentStore",
    "DeviceStack", "MeshDeviceStack", "iter_chunked_draws", "split_budget", "StoreKey",
    "GroupAnswer", "MultiQueryExecutor", "QueryAnswer", "QueryPlan",
    "multi_aggregate", "table_sampler", "distributed",
]
