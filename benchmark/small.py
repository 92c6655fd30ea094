"""Small sizes of the cells for the CPU tests (the card runs them whole)."""

OVERRIDES = {
    "maicity_batch.street": {"traffic": {"frames": 3, "beams": 16, "columns": 128},
                             "config": {"optimizer": {"batch_size": 256},
                                        "tpu": {"scan_chunk": 5}}},
    "rgbd_batch.room": {"traffic": {"frames": 3, "width": 64, "height": 48, "focal": 55.4},
                        "config": {"optimizer": {"batch_size": 256},
                                   "tpu": {"scan_chunk": 5}}},
}
