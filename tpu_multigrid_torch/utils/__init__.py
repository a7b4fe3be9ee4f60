from . import checkpoint, convert, io, native  # noqa: F401
