"""Member steps completed per second of the measured window: members ×
steps over the window's wall time, the device synced at its end. On Atari
an engine step is 4 emulator frames, so frames/s is 4× this."""

UNIT = "steps/s"


def read(rec):
    return rec.member_steps / rec.window_s if rec.steps else None
