"""``mx.nd.random``: the samplers of ``mx.random``, returning NDArrays."""
from ..random import (  # noqa: F401
    exponential,
    gamma,
    generalized_negative_binomial,
    multinomial,
    negative_binomial,
    normal,
    poisson,
    randint,
    randn,
    seed,
    shuffle,
    uniform,
)

__all__ = ["uniform", "normal", "randn", "randint", "multinomial", "shuffle", "gamma",
           "exponential", "poisson", "negative_binomial", "generalized_negative_binomial",
           "seed"]
