from . import cycles, driver, hierarchy  # noqa: F401
