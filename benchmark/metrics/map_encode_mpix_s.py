"""As ``encode_mpix_s``, for the converts that go across the mesh."""


def read(run):
    return run.window.rate("pixels") / 1e6
