"""Device self ms in the program's ``context_text`` span per image: the text
UNet's context blocks over the text context in a multi-context walk."""

from pfdbench import spans


def read(ctx):
    return spans.ms_per_img(ctx, "context_text")
