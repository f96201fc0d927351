"""Operation IDs and message-bus reply ops.

Port of reference: src/main/java/edu/ucla/library/bucketeer/Op.java:14-42.
The 8 OpenAPI operationIds drive HTTP routing; the reply ops are the
request/reply protocol of the internal message bus (success | retry |
failure code).
"""

# OpenAPI operationIds (reference: Op.java:14-33, bucketeer.yaml)
GET_STATUS = "getStatus"
GET_CONFIG = "getConfig"
LOAD_IMAGE = "loadImage"
LOAD_IMAGES_FROM_CSV = "loadImagesFromCSV"
UPDATE_BATCH_JOB = "updateBatchJob"
GET_JOBS = "getJobs"
GET_JOB_STATUSES = "getJobStatuses"
DELETE_JOB = "deleteJob"

ALL_OPERATIONS = (
    GET_STATUS, GET_CONFIG, LOAD_IMAGE, LOAD_IMAGES_FROM_CSV,
    UPDATE_BATCH_JOB, GET_JOBS, GET_JOB_STATUSES, DELETE_JOB,
)

# Reply ops (reference: Op.java:34-42)
SUCCESS = "success"
RETRY = "retry"
FAILURE = "failure"
FS_WRITE_CSV_FAILURE = "fs-write-csv-failure"
