"""Client-side credential registration (SDK creds_utils analogue).

The reference SDK ships `set_gcs_credentials` / `set_s3_credentials` /
`set_azure_credentials` helpers that read local credential files and
create the Secret + ServiceAccount objects the control plane's
credential builder consumes (reference
python/kfserving/kfserving/api/creds_utils.py:26-142).  These helpers do
the same against the control API's /v1/secrets surface: parse the file
client-side, ship only the needed fields, attach to a service account.

File formats match the reference exactly:

- GCS: the service-account JSON key file, shipped verbatim.
- S3: an AWS-CLI credentials file (INI with aws_access_key_id /
  aws_secret_access_key under a profile, creds_utils.py:69-75).
- Azure: the `az ad sp create-for-rbac --sdk-auth` JSON with
  clientId/clientSecret/subscriptionId/tenantId (creds_utils.py:126-134).

Port of ``kfserving_tpu/client/creds.py``.
"""

import configparser
import json
from os.path import expanduser
from typing import Any, Dict, Optional

from kfserving_tpu_torch.storage.credentials import (
    S3_ENDPOINT_ANNOTATION,
    S3_REGION_ANNOTATION,
    S3_USEHTTPS_ANNOTATION,
    S3_VERIFYSSL_ANNOTATION,
)


def gcs_secret_payload(credentials_file: str) -> Dict[str, Any]:
    with open(expanduser(credentials_file)) as f:
        content = f.read()
    # Keep the key file verbatim (the builder writes it back to disk for
    # GOOGLE_APPLICATION_CREDENTIALS); validate it parses so a wrong path
    # fails here, not at model-pull time.
    json.loads(content)
    return {"type": "gcs", "data": {"gcloud": content}}


def s3_secret_payload(credentials_file: str, s3_profile: str = "default",
                      s3_endpoint: Optional[str] = None,
                      s3_region: Optional[str] = None,
                      s3_use_https: Optional[str] = None,
                      s3_verify_ssl: Optional[str] = None
                      ) -> Dict[str, Any]:
    config = configparser.ConfigParser()
    config.read([expanduser(credentials_file)])
    try:
        payload: Dict[str, Any] = {
            "type": "s3",
            "data": {
                "accessKeyId": config.get(s3_profile,
                                          "aws_access_key_id"),
                "secretAccessKey": config.get(s3_profile,
                                              "aws_secret_access_key"),
            },
        }
    except configparser.Error as e:
        # Fail early with the file+profile named, matching the gcs
        # payload's validation, instead of a raw configparser traceback
        # from the CLI.
        raise ValueError(
            f"profile {s3_profile!r} with aws_access_key_id/"
            f"aws_secret_access_key not found in "
            f"{credentials_file}: {e}") from e
    annotations = {}
    for value, key in ((s3_endpoint, S3_ENDPOINT_ANNOTATION),
                       (s3_region, S3_REGION_ANNOTATION),
                       (s3_use_https, S3_USEHTTPS_ANNOTATION),
                       (s3_verify_ssl, S3_VERIFYSSL_ANNOTATION)):
        if value is not None:
            annotations[key] = str(value)
    if annotations:
        payload["annotations"] = annotations
    return payload


def azure_secret_payload(credentials_file: str) -> Dict[str, Any]:
    with open(expanduser(credentials_file)) as f:
        azure_creds = json.load(f)
    return {
        "type": "azure",
        "data": {
            "clientId": azure_creds["clientId"],
            "clientSecret": azure_creds["clientSecret"],
            "subscriptionId": azure_creds["subscriptionId"],
            "tenantId": azure_creds["tenantId"],
        },
    }
