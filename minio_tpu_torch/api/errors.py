"""S3 API errors: code -> (HTTP status, description) and the XML error
body, the port's copy of minio_tpu/api/errors.py (MinIO's
cmd/api-errors.go), cut to the codes the port's server emits.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from http import HTTPStatus


@dataclass(frozen=True)
class APIError:
    code: str
    description: str
    status: int


_E = APIError

API_ERRORS: dict[str, APIError] = {e.code: e for e in [
    _E("AccessDenied", "Access Denied.", HTTPStatus.FORBIDDEN),
    _E("BadDigest", "The Content-Md5 you specified did not match what we received.", HTTPStatus.BAD_REQUEST),
    _E("EntityTooLarge", "Your proposed upload exceeds the maximum allowed object size.", HTTPStatus.BAD_REQUEST),
    _E("EntityTooSmall", "Your proposed upload is smaller than the minimum allowed object size.", HTTPStatus.BAD_REQUEST),
    _E("ExpiredPresignRequest", "Request has expired.", HTTPStatus.FORBIDDEN),
    _E("IncompleteBody", "You did not provide the number of bytes specified by the Content-Length HTTP header.", HTTPStatus.BAD_REQUEST),
    _E("InternalError", "We encountered an internal error, please try again.", HTTPStatus.INTERNAL_SERVER_ERROR),
    _E("InvalidAccessKeyId", "The Access Key Id you provided does not exist in our records.", HTTPStatus.FORBIDDEN),
    _E("InvalidArgument", "Invalid Argument.", HTTPStatus.BAD_REQUEST),
    _E("InvalidTokenId", "The security token included in the request is invalid", HTTPStatus.FORBIDDEN),
    _E("InvalidStorageClass", "The storage class you specified is not "
       "valid.", HTTPStatus.BAD_REQUEST),
    _E("InvalidBucketName", "The specified bucket is not valid.", HTTPStatus.BAD_REQUEST),
    _E("InvalidDigest", "The Content-Md5 you specified is not valid.", HTTPStatus.BAD_REQUEST),
    _E("InvalidPart", "One or more of the specified parts could not be found.", HTTPStatus.BAD_REQUEST),
    _E("InvalidPartOrder", "The list of parts was not in ascending order.", HTTPStatus.BAD_REQUEST),
    _E("InvalidRange", "The requested range is not satisfiable.", HTTPStatus.REQUESTED_RANGE_NOT_SATISFIABLE),
    _E("InvalidRequest", "Invalid Request.", HTTPStatus.BAD_REQUEST),
    _E("MalformedDate", "Invalid date format in request.", HTTPStatus.BAD_REQUEST),
    _E("MalformedPOSTRequest", "The body of your POST request is not well-formed multipart/form-data.", HTTPStatus.BAD_REQUEST),
    _E("MalformedXML", "The XML you provided was not well-formed or did not validate against our published schema.", HTTPStatus.BAD_REQUEST),
    _E("MethodNotAllowed", "The specified method is not allowed against this resource.", HTTPStatus.METHOD_NOT_ALLOWED),
    _E("MissingContentLength", "You must provide the Content-Length HTTP header.", HTTPStatus.LENGTH_REQUIRED),
    _E("MissingDateHeader", "A valid Date or X-Amz-Date header is required for signed requests.", HTTPStatus.BAD_REQUEST),
    _E("NoSuchBucket", "The specified bucket does not exist.", HTTPStatus.NOT_FOUND),
    _E("NoSuchKey", "The specified key does not exist.", HTTPStatus.NOT_FOUND),
    _E("NoSuchUpload", "The specified multipart upload does not exist.", HTTPStatus.NOT_FOUND),
    _E("NoSuchVersion", "The specified version does not exist.", HTTPStatus.NOT_FOUND),
    _E("NotImplemented", "A header you provided implies functionality that is not implemented.", HTTPStatus.NOT_IMPLEMENTED),
    _E("PreconditionFailed", "At least one of the preconditions you specified did not hold.", HTTPStatus.PRECONDITION_FAILED),
    _E("RequestTimeTooSkewed", "The difference between the request time and the server's time is too large.", HTTPStatus.FORBIDDEN),
    _E("SignatureDoesNotMatch", "The request signature we calculated does not match the signature you provided.", HTTPStatus.FORBIDDEN),
    _E("SignatureVersionNotSupported", "The authorization mechanism you have provided is not supported.", HTTPStatus.BAD_REQUEST),
    _E("SlowDown", "Resource requested is unreadable, please reduce your request rate.", HTTPStatus.SERVICE_UNAVAILABLE),
    _E("MetadataTooLarge", "Your metadata headers exceed the maximum allowed metadata size.", HTTPStatus.BAD_REQUEST),
    _E("InsecureSSECustomerRequest", "Requests specifying Server Side Encryption with Customer provided keys must be made over a secure connection.", HTTPStatus.BAD_REQUEST),
    _E("XAmzContentSHA256Mismatch", "The provided 'x-amz-content-sha256' header does not match what was computed.", HTTPStatus.BAD_REQUEST),
    _E("AuthHeaderMalformed", "The authorization header is malformed.", HTTPStatus.BAD_REQUEST),
    _E("CredMalformed", "The credential is malformed.", HTTPStatus.BAD_REQUEST),
    _E("InvalidServiceS3", "The credential scope service must be s3.", HTTPStatus.BAD_REQUEST),
    _E("InvalidQueryParams", "Query-string authentication requires the full set of X-Amz-* parameters.", HTTPStatus.BAD_REQUEST),
    _E("MalformedExpires", "X-Amz-Expires must be a number.", HTTPStatus.BAD_REQUEST),
    _E("NegativeExpires", "X-Amz-Expires must be non-negative.", HTTPStatus.BAD_REQUEST),
    _E("MaximumExpires", "X-Amz-Expires must be less than a week.", HTTPStatus.BAD_REQUEST),
    _E("RequestNotReadyYet", "Request is not valid yet.", HTTPStatus.FORBIDDEN),
    _E("UnsignedHeaders", "There were headers present in the request which were not signed.", HTTPStatus.BAD_REQUEST),
    _E("MalformedChunkedEncoding", "The request body is not properly aws-chunked encoded.", HTTPStatus.BAD_REQUEST),
    _E("InvalidTag", "The tag provided was not a valid tag.",
       HTTPStatus.BAD_REQUEST),
    _E("NoSuchBucketPolicy", "The bucket policy does not exist.", HTTPStatus.NOT_FOUND),
    _E("NoSuchTagSet", "The TagSet does not exist.", HTTPStatus.NOT_FOUND),
    _E("InvalidBucketState", "The request is not valid for the current state of the bucket.", HTTPStatus.CONFLICT),
    _E("NoSuchCORSConfiguration", "The CORS configuration does not exist.", HTTPStatus.NOT_FOUND),
    _E("NoSuchWebsiteConfiguration", "The specified bucket does not have a website configuration.", HTTPStatus.NOT_FOUND),
    _E("ServerSideEncryptionConfigurationNotFoundError", "The server side encryption configuration was not found.", HTTPStatus.NOT_FOUND),
    _E("NoSuchLifecycleConfiguration", "The lifecycle configuration does not exist.", HTTPStatus.NOT_FOUND),
    _E("NoSuchObjectLockConfiguration", "The specified object does not have a ObjectLock configuration.", HTTPStatus.NOT_FOUND),
    _E("ObjectLockConfigurationNotFoundError", "Object Lock configuration does not exist for this bucket.", HTTPStatus.NOT_FOUND),
    _E("QuotaExceeded", "Bucket quota exceeded.", HTTPStatus.CONFLICT),
    _E("InvalidObjectState", "The operation is not valid for the current state of the object.", HTTPStatus.FORBIDDEN),
    _E("ServiceUnavailable", "The server is currently unavailable.", HTTPStatus.SERVICE_UNAVAILABLE),
]}


class S3Error(Exception):
    """Raised by handlers; rendered as an S3 XML error response."""

    def __init__(self, code: str, message: str = "", resource: str = ""):
        err = API_ERRORS.get(code) or API_ERRORS["InternalError"]
        super().__init__(message or err.description)
        self.api = err
        self.resource = resource
        self.detail = message


def error_xml(err: APIError, resource: str, request_id: str,
              detail: str = "") -> bytes:
    root = ET.Element("Error")
    ET.SubElement(root, "Code").text = err.code
    ET.SubElement(root, "Message").text = detail or err.description
    ET.SubElement(root, "Resource").text = resource
    ET.SubElement(root, "RequestId").text = request_id
    ET.SubElement(root, "HostId").text = "minio-tpu"
    return (
        b'<?xml version="1.0" encoding="UTF-8"?>\n'
        + ET.tostring(root, encoding="unicode").encode()
    )


def from_object_error(exc: Exception) -> "S3Error":
    """Map an object-layer StorageError to its S3 API error (MinIO's
    toAPIErrorCode, cmd/api-errors.go)."""
    from ..utils import errors as oe

    mapping = [
        (oe.ErrBucketNotFound, "NoSuchBucket"),
        (oe.ErrObjectNotFound, "NoSuchKey"),
        (oe.ErrVersionNotFound, "NoSuchVersion"),
        (oe.ErrFileVersionNotFound, "NoSuchVersion"),
        (oe.ErrFileNotFound, "NoSuchKey"),
        (oe.ErrInvalidUploadID, "NoSuchUpload"),
        (oe.ErrInvalidPart, "InvalidPart"),
        (oe.ErrInvalidArgument, "InvalidArgument"),
        (oe.ErrMethodNotAllowed, "MethodNotAllowed"),
        (oe.ErrPreconditionFailed, "PreconditionFailed"),
        (oe.ErrErasureReadQuorum, "SlowDown"),
        (oe.ErrErasureWriteQuorum, "SlowDown"),
        (oe.ErrLessData, "IncompleteBody"),
        (oe.ErrBadDigest, "BadDigest"),
        (oe.ErrOperationTimedOut, "SlowDown"),
        (oe.ErrQuotaExceeded, "QuotaExceeded"),
        (oe.ErrRemoteTier, "ServiceUnavailable"),
    ]
    for etype, code in mapping:
        if isinstance(exc, etype):
            return S3Error(code, str(exc))
    return S3Error("InternalError", str(exc))
