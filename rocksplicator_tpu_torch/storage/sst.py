"""SST entry layout constant — counterpart of
``rocksplicator_tpu/storage/sst.py``."""

# bytes per entry besides key+value: u32 klen, u64 seq, u8 vtype, u32 vlen
ENTRY_FIXED_OVERHEAD = 4 + 13
