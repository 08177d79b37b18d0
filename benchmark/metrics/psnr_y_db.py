"""Mean luma PSNR of the reference's decode of the window's shown frames
against the generated source."""


def read(run):
    return sum(run.psnr) / len(run.psnr) if run.psnr else None
