"""Message-field and shared-state names.

Port of the reference's constant namespace (reference:
src/main/java/edu/ucla/library/bucketeer/Constants.java:17-190). These are
the JSON field names used on the internal message bus, in HTTP payloads,
and as shared-state map keys, kept identical so external clients (the
Lambda-style converter callback, monitoring scripts like
src/test/scripts/fake-lambda.sh) work unchanged.
"""

MESSAGES = "bucketeer_messages"

# Message / payload field names
IMAGE_ID = "image-id"
FILE_PATH = "file-path"
JOB_NAME = "job-name"
CALLBACK_URL = "callback-url"
DERIVATIVE_IMAGE = "derivative-image"
CONVERSION_TYPE = "conversion-type"
SLACK_HANDLE = "slack-handle"
FAILURES = "failures"
STATUS = "status"
SUCCESS = "success"
COUNT = "count"
JOBS = "jobs"
REMAINING = "remaining"
NOTHING_PROCESSED = "nothing-processed"
# Admission backpressure: seconds-to-wait hint carried in a 503 reply
# body (engine/scheduler.py QueueFull -> HTTP Retry-After header).
RETRY_AFTER = "retry-after"
# graftscope trace context carried on bus messages: batch-item and S3
# messages are consumed in fresh asyncio tasks (no contextvar
# inheritance), so the request id rides the payload and the consumer
# re-enters it (bucketeer_tpu/obs).
REQUEST_ID = "request-id"
# Per-job dead-letter records in the GET /batch/jobs/{name} detail
# (engine/retry.py DeadLetterLog — items that exhausted their budget).
DEAD_LETTERS = "dead-letters"
BATCH_RESPONSE = "batch-response"
S3_BUCKET = "bucket"

# CSV form field (reference: src/main/webroot/upload/csv/index.html:40-59)
CSV_FILE_UPLOAD = "csvFileToUpload"

# Shared-state names (reference: Constants.java:130-149)
LAMBDA_JOBS = "lambda-jobs"
S3_UPLOADS = "s3-uploads"
S3_REQUEST_COUNT = "s3-request-count"
VERTICLE_MAP = "bucketeer-verticles"
JOB_LOCK = "job-lock"
JOB_LOCK_TIMEOUT = 10.0  # seconds (reference: Constants.java:44-49)
JOB_DELETE_TIMEOUT = 5.0  # seconds (reference: Constants.java:54)

# Misc
SLACK_ERROR_CHANNEL = "slack-error-channel"
WAIT_COUNT = "wait-count"
MAX_WAIT_COUNT = 10

# Content types
CONTENT_TYPE = "Content-Type"
JSON = "application/json"
HTML = "text/html"
CSV = "text/csv"
TEXT = "text/plain"

# Default TIFF file extensions accepted on the batch path
TIFF_EXTS = (".tif", ".tiff", ".TIF", ".TIFF")
JPX_EXT = ".jpx"
JP2_EXT = ".jp2"
