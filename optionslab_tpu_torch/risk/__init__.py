from .expected_shortfall import ExpectedShortfall
from .exposure import (ExposureResult, cva_allocation, cva_dva, cva_greeks, cva_wwr,
                       exposure_profile, xva_report)
from .exposure_amc import AMC_KINDS, ExoticPosition, amc_dynamics_kwargs, amc_exposure_profile
from .exposure_heston import heston_exposure_profile
from .portfolio import OptionsPortfolio, Position
from .sensitivity import SensitivityAnalysis
from .stress import StressScenario, StressTester
from .var import (
    VaRAnalyzer,
    component_es,
    component_var,
    delta_normal_var,
    historical_es,
    historical_var,
    lognormal_var,
    monte_carlo_var,
    option_var,
    parametric_es,
    parametric_var,
    stressed_var,
)

__all__ = [
    "VaRAnalyzer",
    "historical_var",
    "component_var",
    "component_es",
    "historical_es",
    "parametric_var",
    "parametric_es",
    "lognormal_var",
    "monte_carlo_var",
    "delta_normal_var",
    "option_var",
    "stressed_var",
    "ExpectedShortfall",
    "StressScenario",
    "StressTester",
    "SensitivityAnalysis",
    "OptionsPortfolio",
    "Position",
    "ExposureResult",
    "exposure_profile",
    "cva_dva",
    "cva_allocation",
    "cva_greeks",
    "cva_wwr",
    "xva_report",
    "heston_exposure_profile",
    "amc_exposure_profile", "amc_dynamics_kwargs", "ExoticPosition", "AMC_KINDS",
]
