"""Shared type aliases.

The port's own copy of ``glomargridding_tpu/types.py``. The Literal
VALUES are part of the public contract inherited from the GloMarGridding
ecosystem: user configs, saved parameter files (the ``fitting_model`` /
``supercategory_of_fitting_model`` variables of shipped netCDF parameter
sets) and method-selection arguments all carry these exact strings.

- ``ModelType`` / ``FForm`` / ``SuperCategory`` name the six
  non-stationary ellipse families three ways (config name, functional
  form, supercategory): isotropic (one radius), anisotropic (Lx, Ly) and
  anisotropic-rotated (Lx, Ly, theta), each in degrees or, with "_pd",
  in physical distance (km).
- ``DeltaXMethod`` picks the zonal-displacement convention: "Met_Office"
  is the cylindrical Earth; the modified form scales the zonal
  displacement by the pair's mean cos-latitude.
- ``CovarianceMethod`` only tunes the row-block size of the ellipse
  covariance build (``models.ellipse.covariance``).
"""

from typing import Literal

ModelType = Literal[
    "ps2006_kks2011_iso", "ps2006_kks2011_ani", "ps2006_kks2011_ani_r",
    "ps2006_kks2011_iso_pd", "ps2006_kks2011_ani_pd",
    "ps2006_kks2011_ani_r_pd",
]

FForm = Literal[
    "isotropic", "anisotropic", "anisotropic_rotated",
    "isotropic_pd", "anisotropic_pd", "anisotropic_rotated_pd",
]

SuperCategory = Literal[
    "1_param_matern", "2_param_matern", "3_param_matern",
    "1_param_matern_pd", "2_param_matern_pd", "3_param_matern_pd",
]

DeltaXMethod = Literal["Met_Office", "Modified_Met_Office"]
CovarianceMethod = Literal["batched", "low_memory", "array"]
KrigMethod = Literal["simple", "ordinary"]
