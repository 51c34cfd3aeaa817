"""The port's license gate and its pure-Python Ed25519 against the JAX
package's.

``internals/_ed25519.py`` is the verifier ``internals/license.py`` falls
back on where the ``cryptography`` wheel is missing (the card's machine):
it is held to the RFC 8032 test vectors (section 7.1, tests 1-3), its
signatures are byte-equal to the JAX package's copy, and an offline
license file signed by either verifies in both.  ``TelemetryConfig``'s
entitlement gate (a monitoring endpoint needs ``MONITORING``) answers the
same in both packages.
"""

from __future__ import annotations

import base64
import json

import pytest

from pathway_tpu.engine import telemetry as jtelemetry
from pathway_tpu.internals import _ed25519 as jed
from pathway_tpu.internals import license as jlicense
from pathway_tpu_torch.engine import telemetry as ttelemetry
from pathway_tpu_torch.internals import _ed25519 as ted
from pathway_tpu_torch.internals import license as tlicense

# RFC 8032 section 7.1: (secret key, public key, message, signature)
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]
# the signing half of the packages' PUBLIC_KEY (tests/test_telemetry.py)
SIGNING_KEY = bytes.fromhex("682e082b20053bf9591b11eabeadd95a0378e9d6e39a05117e782eaea4485e0b")


@pytest.mark.parametrize("secret,public,message,signature", RFC8032)
def test_rfc8032_vectors(secret, public, message, signature):
    sk, msg = bytes.fromhex(secret), bytes.fromhex(message)
    assert ted.publickey(sk).hex() == public
    assert ted.sign(sk, msg).hex() == signature
    assert ted.verify(bytes.fromhex(public), bytes.fromhex(signature), msg)
    assert not ted.verify(bytes.fromhex(public), bytes.fromhex(signature), msg + b"!")


def license_file(sign, entitlements, policy="enterprise") -> str:
    payload = {"entitlements": entitlements, "policy": policy, "telemetry_required": True}
    enc = base64.b64encode(json.dumps(payload).encode()).decode()
    sig = base64.b64encode(sign(SIGNING_KEY, b"license/" + enc.encode())).decode()
    outer = base64.b64encode(json.dumps({"enc": enc, "sig": sig, "alg": "base64+ed25519"}).encode()).decode()
    return f"-----BEGIN LICENSE FILE-----\n{outer}\n-----END LICENSE FILE-----"


@pytest.mark.parametrize("message", [b"", b"license/abc", bytes(range(256)) * 3])
def test_signatures_are_byte_equal_to_the_jax_package(message):
    assert ted.sign(SIGNING_KEY, message) == jed.sign(SIGNING_KEY, message)
    assert ted.publickey(SIGNING_KEY) == jed.publickey(SIGNING_KEY)
    assert ted.publickey(SIGNING_KEY).hex() == tlicense.PUBLIC_KEY == jlicense.PUBLIC_KEY


def test_an_offline_license_verifies_alike_in_both_packages(monkeypatch):
    text = license_file(ted.sign, ["MONITORING", "XPACK-SHAREPOINT"])
    assert text == license_file(jed.sign, ["MONITORING", "XPACK-SHAREPOINT"])
    got = [tlicense.License.new(text), jlicense.License.new(text)]
    assert [(lic.entitlements, lic.policy, lic.telemetry_required, lic.offline) for lic in got] == [
        (frozenset({"MONITORING", "XPACK-SHAREPOINT"}), "enterprise", True, True)] * 2
    # the pure-Python fallback verifies where the cryptography wheel is missing
    import builtins

    real_import = builtins.__import__

    def no_cryptography(name, *args, **kwargs):
        if name.startswith("cryptography"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cryptography)
    assert tlicense.License.new(text).has_entitlement("monitoring")
    forged = text.replace(text.splitlines()[1], base64.b64encode(json.dumps({
        "enc": base64.b64encode(b'{"entitlements": ["EVERYTHING"]}').decode(),
        "sig": json.loads(base64.b64decode(text.splitlines()[1]))["sig"], "alg": "base64+ed25519"}).encode()).decode())
    for lic in (tlicense, jlicense):
        with pytest.raises(lic.LicenseError):
            lic.License.new(forged)


@pytest.mark.parametrize("key", [None, "demo-license-key-with-telemetry-abc", "ABCDE-FGHIJ-KLMNO-PQRST-UVWXY"])
def test_the_monitoring_endpoint_gate_answers_alike(key):
    outcomes = []
    for lic, tel in ((tlicense, ttelemetry), (jlicense, jtelemetry)):
        license_ = lic.License.new(key)
        try:
            cfg = tel.TelemetryConfig.create(license=license_, run_id="r", monitoring_server="http://127.0.0.1:1")
            outcomes.append(("ok", cfg.telemetry_enabled, cfg.license_shortcut))
        except lic.InsufficientLicenseError as exc:
            outcomes.append(("refused", exc.entitlements, license_.shortcut()))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("ok" if key and key.startswith("demo") else "refused")
