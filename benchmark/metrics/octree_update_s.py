"""Host seconds of the octree's growth in set-up
(``ops.hashgrid.HashGridHost.update``): the traced run's ``data.octree``
spans of set-up, summed (one a frame, on the main thread)."""


def read(rec):
    return rec["spans"]["setup"].get("data.octree")
