"""Science workloads built on the MD engines (reference src/properties/)."""
from .water_sol import (WaterSolMdProperties, run_sol_sim,  # noqa: F401
                        run_sol_sim_fast)
