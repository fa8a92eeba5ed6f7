"""train_images_per_s: the images the window's calls trained on, over the
window's seconds from its start until the device finished its last call
(host clock)."""


def read(rec: dict, name: str) -> float:
    return rec["images"] / rec["window_s"]
