"""Physical constants shared across the framework.

Values match the reference implementation (slcs-jsc/jurassic-gpu,
src/jurassic.h:110-129) including its GSL-2.5 CODATA constants, so that
radiances agree to floating-point tolerance.
"""

# First spectroscopic constant (c_1 = 2 h c^2) [W/(m^2 sr cm^-4)]
C1 = 1.19104259e-8

# Second spectroscopic constant (c_2 = h c / k) [K/cm^-1]
C2 = 1.43877506

# Standard gravity [m/s^2]
G0 = 9.80665

# Standard pressure [hPa]
P0 = 1013.25

# Standard temperature [K]
T0 = 273.15

# Mean radius of Earth [km]
RE = 6367.421

# Mass of Earth [kg]
ME = 5.976e24

# GSL 2.5 constants used by the reference (column densities, hydrostatics)
KB = 1.3806504e-23       # GSL_CONST_MKSA_BOLTZMANN [J/K]
RGAS = 8.314472          # GSL_CONST_MKSA_MOLAR_GAS [J/(mol K)]
NA = 6.02214199e23       # GSL_CONST_NUM_AVOGADRO [1/mol]

# Molar masses used by hydrostatic equilibrium (jr_common.h:733)
MM_AIR = 28.96456e-3     # [kg/mol]
MM_H2O = 18.0153e-3      # [kg/mol]

# Numerical guards of the radiative-transfer core (jr_common.h:239,295)
TAU_OPAQUE = 1e-9        # below this path transmittance a gas is opaque
TAU_CUTOFF = 1e-50       # below this total transmittance no radiance is added
