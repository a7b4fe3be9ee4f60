from . import cycles, driver, eo, hierarchy, krylov  # noqa: F401
