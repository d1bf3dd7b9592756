from .scalar import Fp, P  # noqa: F401
