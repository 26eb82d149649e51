"""scene_build_s: host seconds of apps/common.build_device_scene
(scene tensors, the native cluster build, the copy to the card), the
device synchronized after it."""


def read(run):
    return run.scene_build_s
