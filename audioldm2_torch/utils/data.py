"""Training data pipeline: a metadata-driven audio dataset.

Port of ``audioldm2_tpu/utils/data.py`` (reference
``utilities/data/dataset.py:15-153`` + ``data/add_on.py:30-173``): a JSON
manifest of {"wav": path, "caption"/"text": str, ...} entries, read on the
host into fixed-shape numpy batches that follow the conditioners' batch
contract (``models/conditioners.py``). Corrupt files are skipped by a retry
loop, as the reference does (dataset.py:129-153). The same seed gives the
same example order as the JAX package: ``random.Random(seed)`` shuffles and
crops, ``np.random.default_rng(seed)`` samples. The log-mel and the Kaldi
fbank run on the CPU; the train step moves a batch to its params' device.
The mel's frame count is the reference's (see ``AudioDataset``).
"""

from __future__ import annotations

import collections
import json
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np

from audioldm2_torch.config import ModelConfig
from audioldm2_torch.ops.stft import KaldiFbank, MelSpectrogram
from audioldm2_torch.utils import text as text_utils
from audioldm2_torch.utils.audio_io import read_wav_file


@dataclass
class DatasetConfig:
    metadata_paths: List[str]
    sampling_rate: int = 16000
    duration: float = 10.24
    random_segment: bool = True
    add_ons: tuple = ("kaldi_fbank", "phoneme_and_text")


class AudioDataset:
    """Iterates metadata entries -> model-ready example dicts."""

    def __init__(self, cfg: DatasetConfig, model_cfg: ModelConfig, seed: int = 0):
        from audioldm2_torch.pipeline import _t5_max_length

        self.cfg = cfg
        self.model_cfg = model_cfg
        self.rng = random.Random(seed)
        self.data: List[Dict] = []
        for path in cfg.metadata_paths:
            with open(path) as f:
                meta = json.load(f)
            self.data.extend(meta["data"] if isinstance(meta, dict) else meta)
        if not self.data:
            raise ValueError("empty dataset")

        pp = model_cfg.preprocessing
        self.mel = MelSpectrogram(
            filter_length=pp.filter_length, hop_length=pp.hop_length, win_length=pp.win_length,
            n_mel_channels=pp.n_mel_channels, sampling_rate=pp.sampling_rate,
            mel_fmin=pp.mel_fmin, mel_fmax=pp.mel_fmax,
        )
        self.kaldi = KaldiFbank() if "kaldi_fbank" in cfg.add_ons else None
        self.t5_tok = text_utils.t5_tokenizer(_t5_max_length(model_cfg))
        self.clap_tok = text_utils.roberta_tokenizer()
        self.segment_samples = int(cfg.duration * pp.sampling_rate)
        # the reference's frame count (dataset.py: duration * sr / hop), 1024
        # at 10.24 s; JAX's latent_t_per_second * downsample_factor counts
        # 102.4 frames a second at 16 kHz (1048), a latent the UNet's three
        # halvings do not take back. Both give the tiny configs' 64.
        self.target_frames = round(cfg.duration * pp.sampling_rate / pp.hop_length)

    def __len__(self) -> int:
        return len(self.data)

    def _load_example(self, entry: Dict) -> Dict:
        wav_path = entry.get("wav") or entry.get("file_path")
        wav = read_wav_file(wav_path, None,
                            target_sr=self.model_cfg.preprocessing.sampling_rate)[0]
        if self.cfg.random_segment and wav.shape[-1] > self.segment_samples:
            start = self.rng.randint(0, wav.shape[-1] - self.segment_samples)
            wav = wav[start:start + self.segment_samples]
        if wav.shape[-1] < self.segment_samples:
            wav = np.pad(wav, (0, self.segment_samples - wav.shape[-1]))

        caption = entry.get("caption") or entry.get("text") or ""
        fbank = self.mel.fbank(wav[None], target_length=self.target_frames).numpy()[0]
        out = {"fbank": fbank[..., None], "waveform": wav, "text": caption}  # fbank [T, M, 1]
        if self.kaldi is not None:
            out["ta_kaldi_fbank"] = self.kaldi.normalized(wav[None], target_length=1024).numpy()[0]
        if "phoneme_and_text" in self.cfg.add_ons:
            transcription = entry.get("transcription", "")
            phonemes = text_utils.text_to_phonemes(transcription) if transcription else ""
            out["phoneme_idx"] = text_utils.phoneme_ids([phonemes])[0]
        return out

    def example(self, index: int, max_retries: int = 10) -> Dict:
        """The example at ``index``, or the next readable one (reference
        dataset.py:129-153)."""
        for attempt in range(max_retries):
            entry = self.data[(index + attempt) % len(self.data)]
            try:
                return self._load_example(entry)
            except Exception as e:  # noqa: BLE001 — skip unreadable files, as the reference
                print(f"WARNING: skipping {entry.get('wav')}: {e}")
        raise RuntimeError(f"no readable file near index {index}")

    def batches(self, batch_size: int, shuffle: bool = True) -> Iterator[Dict]:
        """Yields model-ready batch dicts (tokenized text included), epoch
        after epoch."""
        order = list(range(len(self.data)))
        while True:
            if shuffle:
                self.rng.shuffle(order)
            for i in range(0, len(order) - batch_size + 1, batch_size):
                yield self.collate([self.example(j) for j in order[i:i + batch_size]])

    def collate(self, examples: List[Dict]) -> Dict:
        batch: Dict = {}
        for key in ("fbank", "waveform", "ta_kaldi_fbank", "phoneme_idx"):
            if key in examples[0]:
                batch[key] = np.stack([e[key] for e in examples])
        texts = [e["text"] for e in examples]
        batch["text"] = texts
        for name, tok in (("t5", self.t5_tok), ("clap", self.clap_tok)):
            ids, mask = tok(texts)
            uids, umask = tok([""])
            batch.update({f"{name}_ids": ids, f"{name}_mask": mask, f"{name}_uncond_ids": uids,
                          f"{name}_uncond_mask": umask})
        return batch


class BalancedSampler:
    """Class-balanced index sampler (reference utilities/sampler.py:47-588
    family, reduced to its core): entries carry optional "labels"; an
    entry's weight is inversely proportional to its first label's
    frequency."""

    def __init__(self, entries: List[Dict], seed: int = 0):
        self.rng = np.random.default_rng(seed)
        freq: Dict = collections.Counter()
        self.labels = []
        for e in entries:
            label = e.get("labels") or e.get("label") or ""
            label = label.split(",")[0] if isinstance(label, str) else str(label)
            self.labels.append(label)
            freq[label] += 1
        self.weights = np.asarray([1.0 / freq[label] for label in self.labels], np.float64)
        self.weights /= self.weights.sum()

    def sample(self, n: int) -> np.ndarray:
        return self.rng.choice(len(self.labels), size=n, p=self.weights)
