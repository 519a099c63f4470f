"""Physical constants and unit system (copy of molchanica_tpu.constants).

Units: length A, energy kcal/mol, mass amu, charge e, time ps, velocity
A/ps, force kcal/mol/A, temperature K. acceleration = force / mass *
ACCEL_FACTOR, where ACCEL_FACTOR converts (kcal/mol/A)/amu to A/ps^2.
"""

# Coulomb constant e^2/(4 pi eps0) in kcal*A/(mol*e^2).
COULOMB_CONST = 332.0637128

# Boltzmann constant in kcal/(mol*K).
KB = 0.001987204259

# (kcal/mol/A) / amu -> A/ps^2 (4184 J/mol per kcal/mol, 1e-3 kg/mol per amu).
ACCEL_FACTOR = 418.4

# fs -> ps
FS = 1e-3

# Default Amber 1-4 scaling divisors.
SCEE_DEFAULT = 1.2
SCNB_DEFAULT = 2.0

# Pressure: kcal/(mol*A^3) -> bar.
PRESSURE_KCAL_PER_A3_TO_BAR = 69476.95457
BAR_TO_KCAL_PER_A3 = 1.0 / PRESSURE_KCAL_PER_A3_TO_BAR

# Run-configuration defaults.
TAU_TEMP_DEFAULT = 0.1        # ps, CSVR tau
TAU_PRESSURE_DEFAULT = 1.0    # ps
PRESSURE_DEFAULT = 1.0        # bar
LANGEVIN_GAMMA_DEFAULT = 1.0  # 1/ps
TEMP_TARGET_DEFAULT = 310.0   # K

# LINCS / SHAKE defaults.
LINCS_ORDER_DEFAULT = 4
LINCS_ITER_DEFAULT = 2
SHAKE_TOL_DEFAULT = 1e-6
