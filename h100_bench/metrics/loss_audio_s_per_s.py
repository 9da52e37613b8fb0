"""loss_audio_s_per_s: seconds of audio whose cost and gradient the loss
computed in the window (each lattice frame T'_b counts its 40 ms), over
the window's seconds."""


def read(r):
    audio = r.get("loss_audio_s")
    return None if audio is None else audio / r["window_s"]
