"""train_audio_s_per_s: seconds of real (unpadded) input audio in the
training steps that finished in the window (10 ms a frame), over the
window's seconds."""


def read(r):
    audio = r.get("train_audio_s")
    return None if audio is None else audio / r["window_s"]
