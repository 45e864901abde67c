"""h2d_ms_per_img: device time of the host-to-device copies in the traced
window (the `Memcpy HtoD` intervals), in milliseconds, over the images
whose detections reached the host in it."""

UNIT = "ms/img"


def read(view):
    seconds, n = view.device_time(r"HtoD")
    images = view.info.get("images")
    if not n or not images:
        return None
    return 1e3 * seconds / images
