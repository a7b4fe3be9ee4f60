from . import gauge, operators  # noqa: F401
