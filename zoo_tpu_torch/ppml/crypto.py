"""Encrypt-at-rest support (own copy of ``zoo_tpu/ppml/crypto.py``).

AES-CBC/PKCS5 and AES-GCM with a PBKDF2-HMAC-SHA256 key (65,536
iterations), the IV prepended to the ciphertext (16 bytes for CBC, 12
for GCM, whose 16-byte tag follows the ciphertext), Base64 for the
string APIs: the framing of the reference's ``EncryptSupportive``, so
a file written by either package decrypts with the other. The key is
derived with ``hashlib.pbkdf2_hmac``, once per call; the cipher is the
platform's OpenSSL ``libcrypto`` through ``ctypes`` EVP calls, one
pass over the whole buffer in memory.
"""

from __future__ import annotations

import base64
import ctypes
import ctypes.util
import hashlib
import os
from typing import Optional

_ITERATIONS = 65536
_CBC_IV_LEN = 16
_GCM_IV_LEN = 12
_GCM_TAG_LEN = 16
# EVP_CIPHER_CTX_ctrl codes (openssl/evp.h)
_EVP_CTRL_GCM_SET_TAG = 0x11
_EVP_CTRL_GCM_GET_TAG = 0x10
_MODES = ("cbc", "gcm")

_lib: Optional[ctypes.CDLL] = None


def _crypto() -> ctypes.CDLL:
    """libcrypto, loaded once: the name the linker cache gives, then the
    sonames of OpenSSL 3 and 1.1 (``find_library`` returns None where
    no development link is installed). Raises if none loads."""
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("crypto")
    tried = []
    for candidate in ([name] if name else []) + [
            "libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"]:
        try:
            lib = ctypes.CDLL(candidate)
        except OSError as e:
            tried.append(f"{candidate}: {e}")
            continue
        lib.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
        for fn in ("EVP_aes_128_cbc", "EVP_aes_256_cbc",
                   "EVP_aes_128_gcm", "EVP_aes_256_gcm",
                   "EVP_aes_192_cbc", "EVP_aes_192_gcm"):
            getattr(lib, fn).restype = ctypes.c_void_p
        _lib = lib
        return lib
    raise RuntimeError(
        "OpenSSL libcrypto not found; encrypted models need the system "
        "OpenSSL library (tried " + "; ".join(tried) + ")")


def _derive_key(secret: str, salt: str, key_len_bits: int) -> bytes:
    if key_len_bits not in (128, 192, 256):
        raise ValueError(f"AES key length {key_len_bits} (128|192|256)")
    return hashlib.pbkdf2_hmac("sha256", secret.encode(), salt.encode(),
                               _ITERATIONS, dklen=key_len_bits // 8)


def _evp(mode: str, encrypt: bool, key: bytes, iv: bytes, data: bytes,
         start: int = 0, end: Optional[int] = None,
         tag: Optional[bytes] = None) -> bytes:
    """One EVP pass of AES-``mode`` over ``data[start:end]`` (read in
    place, not sliced: a model file is hundreds of MB); a GCM
    encryption appends its tag, a GCM decryption checks ``tag``. A
    failed padding (CBC) or tag (GCM) check raises ``ValueError``."""
    lib = _crypto()
    end = len(data) if end is None else end
    n = end - start
    src = ctypes.c_void_p(
        ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value + start)
    cipher_name = f"EVP_aes_{len(key) * 8}_{mode}"
    cipher = getattr(lib, cipher_name)()
    ctx = lib.EVP_CIPHER_CTX_new()
    if not ctx:
        raise RuntimeError("EVP_CIPHER_CTX_new failed")
    ctx = ctypes.c_void_p(ctx)
    try:
        init = lib.EVP_EncryptInit_ex if encrypt else lib.EVP_DecryptInit_ex
        update = lib.EVP_EncryptUpdate if encrypt else lib.EVP_DecryptUpdate
        final = (lib.EVP_EncryptFinal_ex if encrypt
                 else lib.EVP_DecryptFinal_ex)
        if init(ctx, ctypes.c_void_p(cipher), None, key, iv) != 1:
            raise RuntimeError(f"{cipher_name} init failed")
        # room for a padding block and the GCM tag
        out = ctypes.create_string_buffer(n + 32 + _GCM_TAG_LEN)
        outl = ctypes.c_int(0)
        if update(ctx, out, ctypes.byref(outl), src, n) != 1:
            raise RuntimeError(f"{cipher_name} update failed")
        total = outl.value
        if mode == "gcm" and not encrypt:
            if tag is None or len(tag) != _GCM_TAG_LEN:
                raise ValueError("GCM decryption needs the 16-byte tag")
            if lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_TAG,
                                       len(tag), tag) != 1:
                raise RuntimeError("setting the GCM tag failed")
        finl = ctypes.c_int(0)
        if final(ctx, ctypes.byref(out, total), ctypes.byref(finl)) != 1:
            raise ValueError(
                "decryption failed (wrong secret/salt or corrupted "
                "ciphertext)" if not encrypt else "encryption failed")
        total += finl.value
        if mode == "gcm" and encrypt:
            if lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_GET_TAG,
                                       _GCM_TAG_LEN,
                                       ctypes.byref(out, total)) != 1:
                raise RuntimeError("getting the GCM tag failed")
            total += _GCM_TAG_LEN
        return ctypes.string_at(out, total)
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


def _check_mode(mode: str) -> str:
    if mode not in _MODES:
        raise ValueError(f"invalid cipher mode {mode!r} (cbc|gcm)")
    return mode


class EncryptSupportive:
    """AES-CBC / AES-GCM helpers in the reference's framing."""

    # -- CBC ---------------------------------------------------------------
    @staticmethod
    def encrypt_bytes_with_aes_cbc(content: bytes, secret: str, salt: str,
                                   key_len: int = 128) -> bytes:
        key = _derive_key(secret, salt, key_len)
        iv = os.urandom(_CBC_IV_LEN)
        return iv + _evp("cbc", True, key, iv, content)

    @staticmethod
    def decrypt_bytes_with_aes_cbc(content: bytes, secret: str, salt: str,
                                   key_len: int = 128) -> bytes:
        key = _derive_key(secret, salt, key_len)
        if len(content) < 2 * _CBC_IV_LEN:
            raise ValueError("ciphertext shorter than an IV and a block")
        return _evp("cbc", False, key, content[:_CBC_IV_LEN], content,
                    start=_CBC_IV_LEN)

    @classmethod
    def encrypt_with_aes_cbc(cls, content: str, secret: str, salt: str,
                             key_len: int = 128) -> str:
        return base64.b64encode(cls.encrypt_bytes_with_aes_cbc(
            content.encode(), secret, salt, key_len)).decode()

    @classmethod
    def decrypt_with_aes_cbc(cls, content: str, secret: str, salt: str,
                             key_len: int = 128) -> str:
        return cls.decrypt_bytes_with_aes_cbc(
            base64.b64decode(content), secret, salt, key_len).decode()

    # -- GCM ---------------------------------------------------------------
    @staticmethod
    def encrypt_bytes_with_aes_gcm(content: bytes, secret: str, salt: str,
                                   key_len: int = 128) -> bytes:
        key = _derive_key(secret, salt, key_len)
        iv = os.urandom(_GCM_IV_LEN)
        return iv + _evp("gcm", True, key, iv, content)

    @staticmethod
    def decrypt_bytes_with_aes_gcm(content: bytes, secret: str, salt: str,
                                   key_len: int = 128) -> bytes:
        key = _derive_key(secret, salt, key_len)
        if len(content) < _GCM_IV_LEN + _GCM_TAG_LEN:
            raise ValueError("ciphertext shorter than an IV and a tag")
        return _evp("gcm", False, key, content[:_GCM_IV_LEN], content,
                    start=_GCM_IV_LEN, end=len(content) - _GCM_TAG_LEN,
                    tag=content[-_GCM_TAG_LEN:])

    @classmethod
    def encrypt_with_aes_gcm(cls, content: str, secret: str, salt: str,
                             key_len: int = 128) -> str:
        return base64.b64encode(cls.encrypt_bytes_with_aes_gcm(
            content.encode(), secret, salt, key_len)).decode()

    @classmethod
    def decrypt_with_aes_gcm(cls, content: str, secret: str, salt: str,
                             key_len: int = 128) -> str:
        return cls.decrypt_bytes_with_aes_gcm(
            base64.b64decode(content), secret, salt, key_len).decode()

    # -- bytes by mode, and files ------------------------------------------
    @classmethod
    def encrypt_bytes(cls, content: bytes, secret: str, salt: str,
                      key_len: int = 128, mode: str = "cbc") -> bytes:
        enc = (cls.encrypt_bytes_with_aes_cbc if _check_mode(mode) == "cbc"
               else cls.encrypt_bytes_with_aes_gcm)
        return enc(content, secret, salt, key_len)

    @classmethod
    def decrypt_bytes(cls, content: bytes, secret: str, salt: str,
                      key_len: int = 128, mode: str = "cbc") -> bytes:
        dec = (cls.decrypt_bytes_with_aes_cbc if _check_mode(mode) == "cbc"
               else cls.decrypt_bytes_with_aes_gcm)
        return dec(content, secret, salt, key_len)

    @classmethod
    def encrypt_file(cls, in_path: str, out_path: str, secret: str,
                     salt: str, key_len: int = 128, mode: str = "cbc"):
        with open(in_path, "rb") as f:
            data = f.read()
        with open(out_path, "wb") as f:
            f.write(cls.encrypt_bytes(data, secret, salt, key_len, mode))

    @classmethod
    def decrypt_file(cls, in_path: str, secret: str, salt: str,
                     key_len: int = 128, mode: str = "cbc") -> bytes:
        with open(in_path, "rb") as f:
            data = f.read()
        return cls.decrypt_bytes(data, secret, salt, key_len, mode)
