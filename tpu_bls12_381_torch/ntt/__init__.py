from .domain import Domain, get_domain, release_domain
from .ntt import ntt, intt, coset_ntt, coset_intt, Ordering

__all__ = [
    "Domain",
    "get_domain",
    "release_domain",
    "ntt",
    "intt",
    "coset_ntt",
    "coset_intt",
    "Ordering",
]
