"""crispy-tpu's PyTorch and CUDA port, for an NVIDIA H100.

The JAX package ``crispy_tpu`` is the reference and stays as it is; this
package runs the same pipelines in PyTorch, with the JAX package's Pallas
kernels written again by hand as CUDA kernels for Hopper (``csrc/``, built
at first use by ``_build.py``). It imports neither ``jax`` nor anything of
``crispy_tpu``: what it shares with the JAX package it keeps as its own copy.

  device   device resolution (CUDA unless told otherwise) and TF32 off
  api/     the in-process event bus, ``CrispyApp`` (the app's command
           surface), the model-state tracker and the window logic
  dsp/     the RNNoise pipeline, its kernels and its single-frame step as a
           CUDA graph, RNNoise training data and targets, the Whisper
           log-mel, the resamplers (streaming on the host, polyphase on the
           host or the device)
  engine/  the streaming NS processors and live monitoring, the recording
           mixer and its CRUD, file and array denoising, file transcription,
           speaker diarization (the one-upload frontend, NME-SC on the
           device), chat over transcripts, ffmpeg conversion
  io/      the WAV codec and the incremental stereo writer
  models/  Whisper, the native ASR families, the diarization nets (PyanNet,
           CAM++), the carry of the JAX package's weights, the ONNX weight
           reader, the model catalog and its downloads, real-bundle
           validation
  parallel/ the RNNoise training net and step (one card)
  runtime  the C++ host tier (rings, mixer step, resampler, WAV writer, RMS)
           bound with ctypes, built with g++ at first use
  tools/   ``python -m crispy_tpu_torch.tools.train_rnnoise``
  utils/   the user-data layout, settings, stage timers and device traces,
           the update check, synthetic speaker audio
  cli      ``python -m crispy_tpu_torch.cli denoise IN OUT``, ``bench``,
           ``resample IN OUT --rate R``, ``recordings list|rename|delete``,
           ``transcribe IN [--model ID] [--diarize]``,
           ``models list|download|set|delete|inspect|validate``, ``convert``
           and ``update``
"""

__version__ = "0.1.0"
