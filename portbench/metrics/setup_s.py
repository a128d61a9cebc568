"""Set-up: from the process's start to the window's opening (inputs made,
the program built and every shape of the cell warmed)."""


def read(ctx):
    return ctx.setup_s
