"""Images through whole training steps over the whole window (loader wait,
forward, backward, optimizer, the loop's hooks), host clock."""


def read(record):
    if record.kind != "train" or record.window_s <= 0:
        return None
    return record.images / record.window_s
