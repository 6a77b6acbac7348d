"""Storage engine error taxonomy — counterpart of
``rocksplicator_tpu/storage/errors.py``."""


class StorageError(Exception):
    pass


class NotFoundError(StorageError):
    pass


class Corruption(StorageError):
    pass


class InvalidArgument(StorageError):
    pass
