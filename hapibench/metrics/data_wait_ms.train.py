"""data_wait_ms.train: host ms a step waits from the previous step's return until its batch, read from the object store by COSDataPipeline, is on the card (launch.train.to_device)."""
from hapibench.readings import per_unit_ms


def read(r):
    return per_unit_ms(r, "train", "data")
