"""Volatility surfaces: SVI, SSVI and eSSVI with their static no-arbitrage
checks and repairs, the chain-to-surface calibration, the Dupire surface
from a chain and the dynamic-model fits to a chain; the learned surfaces
(MLP, arbitrage-penalised PINN, kernel ridge, tree ensembles, the scattered
quote interpolator) with grid search; and the surface-model base (scaler,
feature checks, metrics, persistence)."""

from .arbitrage import (
    butterfly_check,
    calendar_check,
    correct_arbitrage,
    detect_arbitrage_violations,
    enforce_calendar,
    enforce_convexity,
    isotonic_pava,
    surface_arbitrage_report,
    validate_domain,
)
from .base import (
    BASE_COLUMNS,
    FEATURE_COLUMNS,
    TARGET_COLUMN,
    StandardScaler,
    VolatilityModelBase,
    regression_metrics,
    validate_features,
)
from .chain_calibration import (ChainCalibrationResult, calibrate_chain,
                                calibrate_model_to_chain, chain_smile_data,
                                local_vol_from_chain, svi_surface_iv_fn)
from .essvi import (ESSVIParams, calibrate_essvi, essvi_g,
                    essvi_surface_iv_fn, essvi_total_variance)
from .features import engineer_features
from .forest import (
    GradientBoostingVolatilityModel,
    RandomForestVolatilityModel,
    XGBVolatilityModel,
)
from .generator import VolatilitySurfaceGenerator
from .grid_search import nested_cross_validate, tune_model
from .kernel_ridge import KernelRidgeModel, SVRModel
from .mlp import MLPModel
from .pinn import PINNVolatilityModel, dryrun_train_step_sharded
from .svi import (
    SSVIModel,
    SSVIParams,
    SVIModel,
    SVIParams,
    calibrate_ssvi,
    calibrate_svi,
    calibrate_svi_surface,
    ssvi_total_variance,
    svi_g,
    svi_implied_vol,
    svi_local_variance,
    svi_total_variance,
)

__all__ = [
    "VolatilityModelBase", "StandardScaler", "regression_metrics",
    "validate_features", "FEATURE_COLUMNS", "BASE_COLUMNS", "TARGET_COLUMN",
    "engineer_features",
    "SVIModel", "SVIParams", "SSVIModel", "SSVIParams", "calibrate_svi",
    "calibrate_ssvi", "calibrate_svi_surface", "svi_total_variance", "svi_implied_vol", "svi_g",
    "svi_local_variance", "ssvi_total_variance",
    "ChainCalibrationResult", "calibrate_chain", "chain_smile_data",
    "svi_surface_iv_fn", "local_vol_from_chain", "calibrate_model_to_chain",
    "ESSVIParams", "calibrate_essvi", "essvi_total_variance", "essvi_g",
    "essvi_surface_iv_fn",
    "MLPModel", "PINNVolatilityModel", "KernelRidgeModel", "SVRModel",
    "RandomForestVolatilityModel", "GradientBoostingVolatilityModel",
    "XGBVolatilityModel", "VolatilitySurfaceGenerator", "dryrun_train_step_sharded",
    "tune_model", "nested_cross_validate",
    "butterfly_check", "calendar_check", "surface_arbitrage_report",
    "validate_domain", "isotonic_pava", "enforce_calendar",
    "enforce_convexity", "detect_arbitrage_violations", "correct_arbitrage",
]
