from . import convert, native  # noqa: F401
