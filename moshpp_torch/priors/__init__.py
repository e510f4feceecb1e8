from moshpp_torch.priors.gmm import (
    MaxMixturePrior,
    gmm_prior_residual,
    make_gmm_prior,
    load_gmm_prior,
    sample_gmm_prior,
)
from moshpp_torch.priors.mahalanobis import (
    MahalanobisPrior,
    mahalanobis_residual,
    load_horse_prior,
    horse_joint_angle_residual,
    load_dog_prior,
)
