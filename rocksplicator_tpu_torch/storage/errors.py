"""Storage errors — counterpart of ``rocksplicator_tpu/storage/errors.py``
(the two the SST reader and writer raise)."""


class StorageError(Exception):
    pass


class Corruption(StorageError):
    pass


class InvalidArgument(StorageError):
    pass
