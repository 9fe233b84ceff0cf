"""Images completed over the window: from its start to the last completion."""


def read(window):
    if not window.requests:
        return None
    end = window.requests[-1][1]
    return sum(n for _, _, n in window.requests) / (end - window.start)
