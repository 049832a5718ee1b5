"""The port's encrypt-at-rest support against the JAX package's.

* ``zoo_tpu_torch.ppml.crypto`` and ``zoo_tpu.ppml.crypto`` decrypt each
  other's ciphertexts (bytes, Base64 strings and files), AES-CBC and
  AES-GCM, 128- and 256-bit keys: the same PBKDF2 key, the same framing.
* A wrong secret fails GCM's tag check and CBC's padding check (the IV
  fixed, so the outcome does not depend on a random draw); with no
  libcrypto to load the first call fails loudly.
* ``save_encrypted`` -> ``InferenceModel.load_encrypted`` round-trips a
  model of the port bit for bit, in memory only.
* ``load_encrypted`` reads the plaintext through the model file's
  allowlist: an encrypted file that names ``os.system`` (called through
  a reduce, or reached by a dotted name) is refused before anything in
  it runs, and the JAX package's encrypted ``.zoo`` file decrypts and is
  then refused with the message a plain one gets.
"""

import base64
import os
import pickle
import re
import types

import jax
import numpy as np
import pytest

from zoo_tpu.common import context as jax_context
from zoo_tpu.pipeline.api.keras.engine.topology import (
    Sequential as JSequential,
)
from zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from zoo_tpu.pipeline.inference import inference_model as jinf
from zoo_tpu.ppml.crypto import EncryptSupportive as JaxCrypto

from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras.engine.topology import MODEL_MAGIC
from zoo_tpu_torch.pipeline.api.keras.layers import Dense
from zoo_tpu_torch.pipeline.inference import InferenceModel, save_encrypted
from zoo_tpu_torch.ppml import crypto as port_crypto
from zoo_tpu_torch.ppml.crypto import EncryptSupportive as PortCrypto

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

MODES = [("cbc", 128), ("cbc", 256), ("gcm", 128), ("gcm", 256)]


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _jax_bytes(mode):
    return (JaxCrypto.encrypt_bytes_with_aes_cbc,
            JaxCrypto.decrypt_bytes_with_aes_cbc) if mode == "cbc" else (
        JaxCrypto.encrypt_bytes_with_aes_gcm,
        JaxCrypto.decrypt_bytes_with_aes_gcm)


@pytest.mark.parametrize("mode,key_len", MODES)
def test_ciphertexts_decrypt_across_packages(mode, key_len, tmp_path):
    jenc, jdec = _jax_bytes(mode)
    rs = np.random.RandomState(key_len)
    for n in (0, 1, 15, 16, 17, 4099):
        data = rs.bytes(n)
        port = PortCrypto.encrypt_bytes(data, "s3cret", "salt", key_len,
                                        mode)
        assert port != data and jdec(port, "s3cret", "salt", key_len) == data
        assert PortCrypto.decrypt_bytes(jenc(data, "s3cret", "salt",
                                             key_len),
                                        "s3cret", "salt", key_len,
                                        mode) == data
    # the Base64 string APIs and the file APIs
    text = "a model manifest, ünïcode included"
    penc = getattr(PortCrypto, f"encrypt_with_aes_{mode}")
    pdec = getattr(PortCrypto, f"decrypt_with_aes_{mode}")
    assert getattr(JaxCrypto, f"decrypt_with_aes_{mode}")(
        penc(text, "k", "s", key_len), "k", "s", key_len) == text
    assert pdec(getattr(JaxCrypto, f"encrypt_with_aes_{mode}")(
        text, "k", "s", key_len), "k", "s", key_len) == text
    plain = tmp_path / "plain.bin"
    plain.write_bytes(rs.bytes(1000))
    PortCrypto.encrypt_file(str(plain), str(tmp_path / "p.enc"), "k", "s",
                            key_len, mode)
    JaxCrypto.encrypt_file(str(plain), str(tmp_path / "j.enc"), "k", "s",
                           key_len, mode)
    assert JaxCrypto.decrypt_file(str(tmp_path / "p.enc"), "k", "s",
                                  key_len, mode) == plain.read_bytes()
    assert PortCrypto.decrypt_file(str(tmp_path / "j.enc"), "k", "s",
                                   key_len, mode) == plain.read_bytes()


def test_the_framing_is_iv_then_body_then_tag(monkeypatch):
    """CBC: 16-byte IV + PKCS5-padded body; GCM: 12-byte IV + body +
    16-byte tag; both packages give the same bytes for the same IV."""
    fixed = types.SimpleNamespace(urandom=lambda n: bytes(range(n)))
    monkeypatch.setattr(port_crypto, "os", fixed)
    data = b"x" * 20
    cbc = PortCrypto.encrypt_bytes(data, "k", "s", 128, "cbc")
    gcm = PortCrypto.encrypt_bytes(data, "k", "s", 128, "gcm")
    assert cbc[:16] == bytes(range(16)) and len(cbc) == 16 + 32
    assert gcm[:12] == bytes(range(12)) and len(gcm) == 12 + 20 + 16
    from zoo_tpu.ppml import crypto as jax_crypto
    monkeypatch.setattr(jax_crypto, "os", fixed)
    assert JaxCrypto.encrypt_bytes_with_aes_cbc(data, "k", "s") == cbc
    assert JaxCrypto.encrypt_bytes_with_aes_gcm(data, "k", "s") == gcm


@pytest.mark.parametrize("mode", ["cbc", "gcm"])
def test_a_wrong_secret_fails_the_tag_or_the_padding(mode, monkeypatch):
    monkeypatch.setattr(port_crypto, "os", types.SimpleNamespace(
        urandom=lambda n: b"\x07" * n))
    blob = PortCrypto.encrypt_bytes(b"weights" * 100, "right", "salt", 128,
                                    mode)
    for secret, salt in (("wrong", "salt"), ("right", "pepper")):
        with pytest.raises(ValueError, match="decryption failed"):
            PortCrypto.decrypt_bytes(blob, secret, salt, 128, mode)
    if mode == "gcm":   # any changed byte fails the tag
        bad = bytearray(blob)
        bad[20] ^= 1
        with pytest.raises(ValueError, match="decryption failed"):
            PortCrypto.decrypt_bytes(bytes(bad), "right", "salt", 128, mode)
    with pytest.raises(ValueError, match="cipher mode"):
        PortCrypto.encrypt_bytes(b"", "k", "s", 128, "ecb")


def _mlp():
    m = Sequential(name="enc")
    m.add(Dense(8, activation="relu", input_shape=(5,)))
    m.add(Dense(3, activation="softmax"))
    m.compile("adam", "mse")
    m.build(device="cpu")
    return m


@pytest.mark.parametrize("mode", ["cbc", "gcm"])
def test_save_encrypted_then_load_encrypted_round_trips(mode, tmp_path,
                                                       monkeypatch):
    m = _mlp()
    path = save_encrypted(m, str(tmp_path / "m.enc"), "kms", "salt",
                          mode=mode)
    raw = open(path, "rb").read()
    assert MODEL_MAGIC not in raw and b"Dense" not in raw
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    im = InferenceModel().load_encrypted(path, "kms", "salt", mode=mode,
                                         batch_size=4, device="cpu")
    np.testing.assert_array_equal(im.predict(x), m.predict(x, device="cpu"))
    with pytest.raises(ValueError, match="decryption failed"):
        InferenceModel().load_encrypted(path, "other", "salt", mode=mode,
                                        device="cpu")
    # quantize=True takes the int8 path in ZOO_INT8_MODE's mode, as
    # load(quantize=True) does
    monkeypatch.setenv("ZOO_INT8_MODE", "force")
    q = InferenceModel().load_encrypted(path, "kms", "salt", mode=mode,
                                        quantize=True, device="cpu")
    assert q.model._quantized


class _CallsSystem:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f"touch {self.marker}",)


def _stack_global(module, name):
    def text(s):
        b = s.encode()
        return b"\x8c" + bytes([len(b)]) + b
    return b"\x80\x04" + text(module) + text(name) + b"\x93."


@pytest.mark.parametrize("payload", ["reduce", "dotted"])
def test_an_encrypted_file_naming_os_system_is_refused(payload, tmp_path):
    marker = tmp_path / "ran"
    body = pickle.dumps(_CallsSystem(marker), protocol=4) \
        if payload == "reduce" else _stack_global("torch", "os.system")
    path = tmp_path / "evil.enc"
    path.write_bytes(PortCrypto.encrypt_bytes(MODEL_MAGIC + body, "k", "s",
                                              128, "gcm"))
    with pytest.raises(pickle.UnpicklingError, match=re.escape(
            "may not name") + ".*system"):
        InferenceModel().load_encrypted(str(path), "k", "s", mode="gcm",
                                        device="cpu")
    assert not marker.exists()


def test_an_encrypted_jax_zoo_file_is_refused_as_a_plain_one(tmp_path):
    jm = JSequential(name="jax_served")
    jm.add(JDense(4, input_shape=(2,)))
    jm.build()
    plain = str(tmp_path / "m.zoo")
    jm.save(plain)
    enc = jinf.save_encrypted(jm, str(tmp_path / "m.enc"), "k", "s",
                              mode="cbc")
    with pytest.raises(ValueError) as plain_err:
        InferenceModel().load(plain, device="cpu")
    with pytest.raises(ValueError) as enc_err:
        InferenceModel().load_encrypted(enc, "k", "s", device="cpu")
    tail = str(plain_err.value).split(" is not a model file", 1)[1]
    assert str(enc_err.value).endswith(tail)
    assert str(enc_err.value).startswith(f"{enc} (decrypted) is not")


def test_the_model_key_knobs_are_the_jax_registrys():
    from zoo_tpu.common import knobs as jax_knobs
    from zoo_tpu_torch.common import knobs
    for name in ("ZOO_MODEL_SECRET", "ZOO_MODEL_SALT", "ZOO_MODEL_ENC_MODE"):
        mine, ref = knobs.get(name), jax_knobs.get(name)
        assert (mine.type, mine.default) == (ref.type, ref.default), name
    assert knobs.value("ZOO_MODEL_ENC_MODE", {}) == "cbc"


def test_string_api_is_base64_of_the_byte_api():
    s = PortCrypto.encrypt_with_aes_gcm("hi", "k", "s")
    raw = base64.b64decode(s)
    assert PortCrypto.decrypt_bytes_with_aes_gcm(raw, "k", "s") == b"hi"


def test_a_missing_libcrypto_fails_loudly(monkeypatch):
    """Where no libcrypto loads (no linker-cache entry, no soname), the
    first cipher call raises naming OpenSSL and every name it tried."""
    import ctypes

    def no_lib(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(port_crypto, "_lib", None)
    monkeypatch.setattr(port_crypto.ctypes.util, "find_library",
                        lambda name: None)
    monkeypatch.setattr(ctypes, "CDLL", no_lib)
    with pytest.raises(RuntimeError, match="OpenSSL libcrypto not found.*"
                       "libcrypto.so.3"):
        PortCrypto.encrypt_bytes(b"x", "k", "s")
